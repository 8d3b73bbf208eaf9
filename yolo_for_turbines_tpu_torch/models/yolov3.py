"""YOLOv3 (Darknet-53, CSPDarknet-53 or tiny backbone + heads) in PyTorch,
trainable and folded.

Counterpart of ``yolo_for_turbines_tpu/models/yolov3.py``: the same layer
DSL and static plan, and two ``nn.Module``s over it:

- ``YOLOv3``, the trainable model (conv + BN with running statistics +
  activation), with the semantics of ``apply(plan, params, batch_stats, x,
  train=...)``: ``.train()`` / ``.eval()`` choose the mode, the heads come
  out as ``(B, A, S, S, 5+C)`` float32, and ``fold()`` gives the folded tree
  of ``fold_params``;
- ``FoldedYOLOv3``, with the semantics of ``apply_inference(...,
  raw_heads=True)`` over BN-folded weights (conv + bias + activation per
  layer), which serves.

Routes are saved at the 8-block residual and CSP stages and at a
``PlanRoute`` (tiny), and popped LIFO after each upsample; a concat is
``[upsampled, route]``; a head is a branch and the trunk continues from the
head's input. The backbone follows ``cfg.backbone`` (``cspdarknet53``:
``models/cspdarknet.py``; ``yolov3_tiny``: ``models/yolov3_tiny.py``)
unless ``cfg.layer_config`` is set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.kernels.resblock_kernel import (
    KERNEL_C,
    fused_residual_stage,
    kmajor_weights,
    stack_block_params,
    stage_wins,
)
from .blocks import ConvBlock, FoldedConv, get_activation, maxpool2d, upsample2x
from .cspdarknet import (
    CSP_LAYER_CONFIG,
    CSPStage,
    PlanCSP,
    TrainableCSPStage,
    conv_shapes,
    map_stage,
)

# Same declarative architecture list as the JAX package (reference:
# code/model.py:20-45).
LAYER_CONFIG = (
    (32, 3, 1),
    (64, 3, 2),
    ("B", 1),
    (128, 3, 2),
    ("B", 2),
    (256, 3, 2),
    ("B", 8),  # route to detection head
    (512, 3, 2),
    ("B", 8),  # route to detection head
    (1024, 3, 2),
    ("B", 4),  # end of Darknet-53
    (512, 1, 1),
    (1024, 3, 1),
    "S",
    (256, 1, 1),
    "U",
    (256, 1, 1),
    (512, 3, 1),
    "S",
    (128, 1, 1),
    "U",
    (128, 1, 1),
    (256, 3, 1),
    "S",
)


# ---------------------------------------------------------------------------
# Plan (static description of the layer sequence)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanConv:
    in_ch: int
    out_ch: int
    kernel: int
    stride: int
    bn: bool = True


@dataclasses.dataclass(frozen=True)
class PlanResidual:
    channels: int
    num_blocks: int
    use_residual: bool = True
    save_route: bool = False  # feature map feeds a later concat


@dataclasses.dataclass(frozen=True)
class PlanHead:
    """3x3 conv (to mid_ch, default 2*in_ch) then a 1x1 with bias and no BN
    to A*(5+C) channels; a branch: the trunk continues from its input."""

    in_ch: int
    num_classes: int
    anchors_per_scale: int = 3
    mid_ch: Optional[int] = None

    @property
    def mid(self) -> int:
        return self.mid_ch if self.mid_ch is not None else 2 * self.in_ch


@dataclasses.dataclass(frozen=True)
class PlanMaxPool:
    """Max pool (tiny-YOLO backbone); stride 1 = SAME padding."""

    kernel: int = 2
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class PlanRoute:
    """Explicit route marker (tiny-YOLO)."""


@dataclasses.dataclass(frozen=True)
class PlanUpsample:
    """Nearest 2x upsample + channel concat with the most recent saved route."""

    in_ch: int


Plan = Tuple


def build_plan(cfg: ModelConfig, layer_config=None) -> Plan:
    """Walk the layer DSL into a static plan (reference: code/model.py:195-225).

    The DSL is ``cfg.layer_config`` when set, else ``layer_config`` when
    given, else the backbone's: ``CSP_LAYER_CONFIG`` for ``cspdarknet53``,
    ``build_tiny_plan`` for ``yolov3_tiny`` and ``LAYER_CONFIG`` for any
    other name, as ``YOLOv3.plan`` of the JAX package chooses."""
    if cfg.layer_config is not None:
        layer_config = cfg.layer_config
    elif layer_config is None:
        if cfg.backbone == "yolov3_tiny":
            from .yolov3_tiny import build_tiny_plan

            return build_tiny_plan(cfg)
        layer_config = CSP_LAYER_CONFIG if cfg.backbone == "cspdarknet53" else LAYER_CONFIG
    plan: List = []
    in_ch = cfg.in_channels
    first_csp = True
    for block in layer_config:
        if isinstance(block, tuple) and block[0] == "B":
            n = block[1]
            plan.append(
                PlanResidual(channels=in_ch, num_blocks=n, save_route=(n == 8))
            )
        elif isinstance(block, tuple) and block[0] == "C":
            n = block[1]
            plan.append(PlanCSP(channels=in_ch, num_blocks=n, save_route=(n == 8),
                                first_stage=first_csp))
            first_csp = False
        elif isinstance(block, tuple):
            out_ch, k, s = block
            plan.append(PlanConv(in_ch, out_ch, kernel=k, stride=s))
            in_ch = out_ch
        elif block == "S":
            plan.append(PlanResidual(channels=in_ch, num_blocks=1, use_residual=False))
            plan.append(PlanConv(in_ch, in_ch // 2, kernel=1, stride=1))
            plan.append(PlanHead(in_ch // 2, cfg.num_classes, cfg.anchors_per_scale))
            in_ch = in_ch // 2
        elif block == "U":
            plan.append(PlanUpsample(in_ch))
            in_ch = in_ch * 3  # concat with a route that has 2x our channels
        else:
            raise ValueError(f"Unknown layer config entry: {block!r}")
    return tuple(plan)


def param_count(params) -> int:
    """Elements of a module's parameters, or of the leaves of a tree of
    arrays (a JAX-layout tree of ``fold()`` or ``trainable_to_numpy``)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return 0 if params is None else int(np.prod(params.shape))


def jax_layout(w: torch.Tensor, b: torch.Tensor) -> dict:
    """An OIHW conv weight and its bias as the JAX tree's {"w": HWIO, "b"}
    numpy float32 arrays."""
    w = w.detach().float().cpu().permute(2, 3, 1, 0)  # OIHW -> HWIO
    return {"w": w.contiguous().numpy(), "b": b.detach().float().cpu().numpy()}


def _head_reshape(y, num_classes: int, anchors: int):
    """NHWC (B,S,S,A*(5+C)) -> (B,A,S,S,5+C) f32, channel order [anchor,
    channel] with channel fastest (reference: code/model.py:146-148)."""
    b, h, w, _ = y.shape
    return y.float().reshape(b, h, w, anchors, num_classes + 5).permute(0, 3, 1, 2, 4)


# ---------------------------------------------------------------------------
# The trainable model
# ---------------------------------------------------------------------------


class TrainableResidualStage(nn.Module):
    """A stack of residual blocks (1x1 halve, 3x3 restore), each conv + BN."""

    def __init__(self, entry: PlanResidual, generator=None):
        super().__init__()
        c = entry.channels
        self.entry = entry
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"conv1": ConvBlock(c, c // 2, 1, generator=generator),
                           "conv2": ConvBlock(c // 2, c, 3, generator=generator)})
            for _ in range(entry.num_blocks)
        )

    def forward(self, x, act, rows=None):
        for blk in self.blocks:
            y = blk["conv2"](blk["conv1"](x, act, rows), act, rows)
            x = x + y if self.entry.use_residual else y
        return x


class TrainableHead(nn.Module):
    """3x3 conv + BN + activation, then a 1x1 with a bias and no BN."""

    def __init__(self, entry: PlanHead, generator=None):
        super().__init__()
        out_ch = (entry.num_classes + 5) * entry.anchors_per_scale
        self.entry = entry
        self.conv1 = ConvBlock(entry.in_ch, entry.mid, 3, generator=generator)
        self.conv2 = ConvBlock(entry.mid, out_ch, 1, bn=False, generator=generator)

    def forward(self, x, act, rows=None):
        return self.conv2(self.conv1(x, act, rows), rows=rows)


class YOLOv3(nn.Module):
    """The trainable model: conv + BN + activation per layer.

    ``forward`` takes an NHWC image batch and returns one head per scale,
    coarsest first, each ``(B, A, S, S, 5+C)`` float32: the counterpart of
    ``apply(..., train=self.training)``. Train mode normalizes with the
    batch statistics and updates the running ones; eval mode reads them.
    The module runs in its parameters' dtype; mixed precision is the
    caller's ``torch.autocast``. The JAX package's space-to-depth stem
    (``cfg.s2d_stem``) is arithmetically the plain stem, which runs here.
    Weights are drawn from ``generator`` as ``init_conv`` draws them.
    """

    def __init__(self, cfg: ModelConfig, plan: Optional[Plan] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg) if plan is None else plan
        layers = []
        for entry in self.plan:
            if isinstance(entry, PlanConv):
                layers.append(ConvBlock(entry.in_ch, entry.out_ch, entry.kernel, entry.stride,
                                        bn=entry.bn, generator=generator))
            elif isinstance(entry, PlanResidual):
                layers.append(TrainableResidualStage(entry, generator))
            elif isinstance(entry, PlanCSP):
                layers.append(TrainableCSPStage(entry, generator))
            elif isinstance(entry, PlanHead):
                layers.append(TrainableHead(entry, generator))
            elif isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
                layers.append(nn.Identity())
            else:
                raise TypeError(f"unknown plan entry {entry!r}")
        self.layers = nn.ModuleList(layers)

    @property
    def strides(self) -> Tuple[int, ...]:
        return self.cfg.strides

    def forward(self, x: torch.Tensor, layout=None) -> List[torch.Tensor]:
        """``layout`` (``parallel/spatial.py::Layout``) runs the forward on a
        mesh: x is then this rank's shard, train-mode BN takes the mesh's
        batch moments, and under SP the rows shard by its policy, the heads
        gathered."""
        act = get_activation(self.cfg.activation)

        def head(entry, y):
            return _head_reshape(y.permute(0, 2, 3, 1), entry.num_classes,
                                 entry.anchors_per_scale)

        return _walk(self, x, layout, act, lambda layer, x, rows: layer(x, act, rows), head)

    @torch.no_grad()
    def fold(self) -> list:
        """Every eval-mode BN folded into its conv (``fold_params``): a
        folded tree in the JAX layout (HWIO numpy float32), which
        ``models/convert.py::folded_from_numpy`` and
        ``Predictor.from_folded`` take."""

        def conv(block: ConvBlock) -> dict:
            return jax_layout(**block.folded())

        folded = []
        for layer in self.layers:
            if isinstance(layer, ConvBlock):
                folded.append({"conv": conv(layer)})
            elif isinstance(layer, TrainableResidualStage):
                folded.append({"blocks": [{k: conv(blk[k]) for k in ("conv1", "conv2")}
                                          for blk in layer.blocks]})
            elif isinstance(layer, TrainableCSPStage):
                folded.append(map_stage(layer, conv))
            elif isinstance(layer, TrainableHead):
                folded.append({"conv1": conv(layer.conv1), "conv2": conv(layer.conv2)})
            else:
                folded.append({})
        return folded


# ---------------------------------------------------------------------------
# Init of a folded tree
# ---------------------------------------------------------------------------


def _init_folded_conv(gen, in_ch, out_ch, kernel, bn=True):
    """Folded twin of the JAX ``init_conv``: weights U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) in HWIO; a fresh BN (scale 1, bias 0, mean 0, var 1)
    folds to w / sqrt(1 + eps) and a zero bias; a head's 1x1 keeps its
    uniform bias."""
    bound = 1.0 / math.sqrt(in_ch * kernel * kernel)
    w = (torch.rand(kernel, kernel, in_ch, out_ch, generator=gen) * 2 - 1) * bound
    if bn:
        return {"w": w / math.sqrt(1.0 + 1e-5), "b": torch.zeros(out_ch)}
    return {"w": w, "b": (torch.rand(out_ch, generator=gen) * 2 - 1) * bound}


def init_plan(plan: Plan, generator: torch.Generator):
    """Random folded tree aligned with a plan, in the layout of the JAX
    ``fold_params`` output (HWIO weights), as CPU float32 tensors."""
    folded = []
    for entry in plan:
        if isinstance(entry, PlanConv):
            folded.append({"conv": _init_folded_conv(
                generator, entry.in_ch, entry.out_ch, entry.kernel, entry.bn)})
        elif isinstance(entry, PlanResidual):
            c = entry.channels
            folded.append({"blocks": [
                {"conv1": _init_folded_conv(generator, c, c // 2, 1),
                 "conv2": _init_folded_conv(generator, c // 2, c, 3)}
                for _ in range(entry.num_blocks)
            ]})
        elif isinstance(entry, PlanCSP):
            # drawn in the module's order: split1, split2, the blocks,
            # transition, fuse
            shapes = conv_shapes(entry)
            names = ["split1", "split2", *["conv1", "conv2"] * entry.num_blocks,
                     "transition", "fuse"]
            convs = [_init_folded_conv(generator, *shapes[k]) for k in names]
            stage = dict(zip(("split1", "split2"), convs[:2]))
            stage["blocks"] = [{"conv1": convs[i], "conv2": convs[i + 1]}
                               for i in range(2, len(convs) - 2, 2)]
            stage.update(zip(("transition", "fuse"), convs[-2:]))
            folded.append(stage)
        elif isinstance(entry, PlanHead):
            out_ch = (entry.num_classes + 5) * entry.anchors_per_scale
            folded.append({
                "conv1": _init_folded_conv(generator, entry.in_ch, entry.mid, 3),
                "conv2": _init_folded_conv(generator, entry.mid, out_ch, 1, bn=False),
            })
        elif isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
            folded.append({})
        else:
            raise TypeError(f"unknown plan entry {entry!r}")
    return folded


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class ResidualStage(nn.Module):
    """A stack of folded residual blocks (1x1 halve, 3x3 restore)."""

    def __init__(self, entry: PlanResidual):
        super().__init__()
        c = entry.channels
        self.entry = entry
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"conv1": FoldedConv(c, c // 2, 1),
                           "conv2": FoldedConv(c // 2, c, 3)})
            for _ in range(entry.num_blocks)
        )
        self._stacked = None
        self._kmajor = None
        self._weights_key = None

    def drop_kernel_copies(self):
        """Forget the stacked and K-major copies: the next routed call
        makes them again from the blocks' weights."""
        self._stacked = None
        self._kmajor = None
        self._weights_key = None

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .half() replace the weights (and may free
        # storage that a new tensor then reuses at the same address)
        self.drop_kernel_copies()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        # load_state_dict() overwrites the weights in place
        self.drop_kernel_copies()
        return super()._load_from_state_dict(*args, **kwargs)

    def _current_copies(self):
        """Drop the copies when a weight moved or was written in place since
        they were made: each weight's (data_ptr, _version) is their key. A
        collective that writes a weight's storage directly (a broadcast)
        leaves ``_version`` as it was, so its caller drops the copies
        itself (``FoldedYOLOv3.drop_kernel_copies``); so does one that
        writes a weight made under ``torch.inference_mode``, which has no
        version counter."""
        key = tuple((p.data_ptr(), -1 if p.is_inference() else p._version)
                    for p in self.parameters())
        if key != self._weights_key:
            self.drop_kernel_copies()
            self._weights_key = key

    def stacked(self):
        """The blocks' weights in the fused kernel's layout (cached while
        the weights stay as they are)."""
        self._current_copies()
        if self._stacked is None:
            self._stacked = stack_block_params([
                {k: {"w": blk[k].weight, "b": blk[k].bias} for k in ("conv1", "conv2")}
                for blk in self.blocks
            ])
        return self._stacked

    def kmajor(self):
        """The K-major copies of the stacked weights that the CUDA kernel
        reads (``kmajor_weights``, cached with ``stacked``), for a stage
        whose channel count and dtype the kernel takes (C = 512, bf16);
        None otherwise. ``forward`` asks for them only when a call on CUDA
        is routed to the kernel."""
        w1s, _, w2s, _ = self.stacked()
        if self._kmajor is None and self.entry.channels == KERNEL_C:
            if w1s.dtype == torch.bfloat16:
                self._kmajor = kmajor_weights(w1s, w2s)
        return self._kmajor

    def forward(self, x, act, activation: str, fuse: bool, rows=None):
        _, c, h, w = x.shape
        if (fuse and rows is None and self.entry.use_residual
                and stage_wins(h, w, c, x.dtype, x.device.type)):
            # NCHW channels_last storage is NHWC: permute + contiguous is free
            fused = fused_residual_stage(
                x.permute(0, 2, 3, 1).contiguous(), *self.stacked(), activation=activation,
                kmajor=self.kmajor() if x.is_cuda else None,
            )
            return fused.permute(0, 3, 1, 2)
        for blk in self.blocks:
            y = blk["conv1"](x, act, rows)
            x = blk["conv2"](y, act, rows, skip=x if self.entry.use_residual else None)
        return x


class Head(nn.Module):
    def __init__(self, entry: PlanHead):
        super().__init__()
        out_ch = (entry.num_classes + 5) * entry.anchors_per_scale
        self.conv1 = FoldedConv(entry.in_ch, entry.mid, 3)
        self.conv2 = FoldedConv(entry.mid, out_ch, 1)

    def forward(self, x, act, rows=None):
        return self.conv2(self.conv1(x, act, rows), rows=rows)


class FoldedYOLOv3(nn.Module):
    """Folded-BN inference forward with raw heads.

    ``forward`` takes an NHWC image batch in [0, 1] and returns one raw head
    per scale, coarsest first, each NHWC ``(B, S, S, A*(5+C))`` in the
    module's dtype (``apply_inference(..., raw_heads=True)``). Inside, the
    trunk runs NCHW; with ``memory_format=torch.channels_last`` weights the
    activations are NHWC in memory, which is what the fused residual kernel
    takes.
    """

    def __init__(self, cfg: ModelConfig, plan: Optional[Plan] = None):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg) if plan is None else plan
        layers = []
        for entry in self.plan:
            if isinstance(entry, PlanConv):
                layers.append(FoldedConv(entry.in_ch, entry.out_ch, entry.kernel, entry.stride))
            elif isinstance(entry, PlanResidual):
                layers.append(ResidualStage(entry))
            elif isinstance(entry, PlanCSP):
                layers.append(CSPStage(entry))
            elif isinstance(entry, PlanHead):
                layers.append(Head(entry))
            elif isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
                layers.append(nn.Identity())
            else:
                raise TypeError(f"unknown plan entry {entry!r}")
        self.layers = nn.ModuleList(layers)
        # cfg.s2d_stem is a train-mode TPU layout and is ignored here
        self.fuse_resblocks = cfg.fuse_resblocks

    @property
    def strides(self) -> Tuple[int, ...]:
        return self.cfg.strides

    def drop_kernel_copies(self) -> None:
        """Forget every stage's stacked and K-major weight copies (K2's
        operands). A stage notices a weight written in place by torch (its
        ``_version``); a collective that writes the storage directly (a
        broadcast) does not bump it, so the caller drops the copies."""
        for m in self.modules():
            if isinstance(m, ResidualStage):
                m.drop_kernel_copies()

    def forward(self, x: torch.Tensor, layout=None) -> List[torch.Tensor]:
        """``layout`` (``parallel/spatial.py::Layout``): the rank's row shard
        under SP, the heads gathered; the fused stage is not routed."""
        act = get_activation(self.cfg.activation)
        name = self.cfg.activation

        def residual(layer, x, rows):
            if isinstance(layer, ResidualStage):
                return layer(x, act, name, self.fuse_resblocks, rows)
            return layer(x, act, rows)

        return _walk(self, x, layout, act, residual,
                     lambda entry, y: y.permute(0, 2, 3, 1))


def _walk(model, x, layout, act, stage, head) -> List[torch.Tensor]:
    """The plan's walk, shared by both modules: NHWC ``x`` in, one head per
    scale out (``head(entry, NCHW y)``); ``stage(layer, x, rows)`` runs a
    residual or CSP stage. Routes are saved at the 8-block stages and at a
    ``PlanRoute`` and popped LIFO after each upsample; a concat is
    ``[upsampled, route]``; a head is a branch.

    With a ``layout``, ``rows`` says how each activation lies on the mesh;
    ``layout.constrain`` re-lays it where the height changes (the JAX
    ``constrain`` points) and the heads are gathered."""
    x = x.to(next(model.parameters()).dtype).permute(0, 3, 1, 2)
    rows = None
    if layout is not None:
        x, rows = layout.enter(x)
    preds: List[torch.Tensor] = []
    routes: List[torch.Tensor] = []
    for entry, layer in zip(model.plan, model.layers):
        if isinstance(entry, (PlanConv, PlanMaxPool)):
            if rows is not None:
                x, rows = layout.fit(x, rows, entry.stride)
            if isinstance(entry, PlanConv):
                x = layer(x, act, rows)
            elif rows is None:
                x = maxpool2d(x, entry.kernel, entry.stride)
            else:
                x = rows.pool(x, entry.kernel, entry.stride)
            if rows is not None:
                x, rows = layout.constrain(x, rows)
        elif isinstance(entry, (PlanResidual, PlanCSP)):
            x = stage(layer, x, rows)
            if entry.save_route:
                routes.append(x)
        elif isinstance(entry, PlanHead):
            y = layer(x, act, rows)
            preds.append(head(entry, y if rows is None else layout.gather(y, rows)))
        elif isinstance(entry, PlanRoute):
            routes.append(x)
        elif isinstance(entry, PlanUpsample):
            x = upsample2x(x)
            if rows is not None:
                # the route was laid out at this height by the same rule
                x, rows = layout.constrain(x, rows)
            x = torch.cat([x, routes.pop().to(x.dtype)], dim=1)
    return preds
