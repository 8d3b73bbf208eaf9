"""YOLOv3 (Darknet-53, CSPDarknet-53 or tiny backbone + heads), YOLOv4 and
YOLOv7 in PyTorch, trainable and folded.

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
``PlanRoute`` (tiny), and popped LIFO after each upsample; such a concat is
``[upsampled, route]``. A YOLOv4 plan (``YOLOV4_LAYER_CONFIG``, the
``yolov4`` backbone) also saves routes by name (``PlanSave``) and reads
them by name: a lateral 1x1 on a saved route concatenated with the
upsampled trunk (``PlanLateral``, ``[lateral, upsampled]``), PANet's
bottom-up join (``PlanJoin``, ``[trunk, route]``) and SPP's pools
(``PlanSPP``); ``PlanActivation`` switches the activation of the convs and
heads after it. A head is a branch and the trunk continues from the head's
input; heads come out in the plan's order, which is its ``strides``' order
(coarsest first for YOLOv3, finest first for YOLOv4 and YOLOv7). A YOLOv7
plan (``YOLOV7_LAYER_CONFIG``, the ``yolov7`` backbone) adds E-ELAN, MP and
SPPCSPC entries (``models/yolov7.py``) to YOLOv4's named routes, and its
heads (``PlanRepHead``) decode sizes squared; its trainable heads are
RepConv and IDetect's implicit 1x1, which ``fold()`` re-parameterises. The
backbone follows ``cfg.backbone`` (``cspdarknet53``:
``models/cspdarknet.py``; ``yolov3_tiny``: ``models/yolov3_tiny.py``;
``yolov4``; ``yolov7``) unless ``cfg.layer_config`` is set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import ClassVar, Iterator, List, Optional, Tuple

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
from ..utils.profiling import span
from . import rtdetr
from .blocks import (
    ChannelConcat,
    ConvBlock,
    FoldedConv,
    ImplicitConv,
    LayerNorm,
    Linear,
    RepConvBlock,
    get_activation,
    maxpool2d,
    maxpool_pyramid,
    residual_blocks,
    upsample2x,
)
from .cspdarknet import (
    CSP_LAYER_CONFIG,
    CSPStage,
    PlanCSP,
    TrainableCSPStage,
)
from .rtdetr import DETR_ENTRIES, RTDETR_LAYER_CONFIG, PlanDETRDecoder
from .yolov7 import ELAN, ELAN_PICKS, SPPCSPC, MPDown, PlanELAN, PlanMP, PlanSPPCSPC

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

# YOLOv4 (Bochkovskiy, Wang and Liao, arXiv:2004.10934), the layers of
# darknet's cfg/yolov4.cfg: the CSPDarknet-53 backbone under mish (its CSP
# stages are CSP_LAYER_CONFIG's), then leaky: three convs, SPP, three convs
# (P5), the top-down path (a lateral 1x1 on C4, then on C3, each
# concatenated with the upsampled trunk: P4, N3) and PANet's bottom-up path
# (a stride-2 conv joined with P4, then with P5); heads finest first, each
# with its grid-sensitive ``scale_x_y``. ``strides=(8, 16, 32)``,
# ``config.YOLOV4_ANCHORS``.
YOLOV4_LAYER_CONFIG = (
    (32, 3, 1),
    (64, 3, 2),
    ("C", 1),
    (128, 3, 2),
    ("C", 2),
    (256, 3, 2),
    ("C", 8),
    ("save", "c3"),
    (512, 3, 2),
    ("C", 8),
    ("save", "c4"),
    (1024, 3, 2),
    ("C", 4),  # C5
    ("act", "leaky_relu"),
    (512, 1, 1),
    (1024, 3, 1),
    (512, 1, 1),
    ("spp", 5, 9, 13),
    (512, 1, 1),
    (1024, 3, 1),
    (512, 1, 1),
    ("save", "p5"),
    (256, 1, 1),
    ("lateral", "c4", 256),
    (256, 1, 1),
    (512, 3, 1),
    (256, 1, 1),
    (512, 3, 1),
    (256, 1, 1),
    ("save", "p4"),
    (128, 1, 1),
    ("lateral", "c3", 128),
    (128, 1, 1),
    (256, 3, 1),
    (128, 1, 1),
    (256, 3, 1),
    (128, 1, 1),  # N3
    ("head", 1.2),  # stride 8
    (256, 3, 2),
    ("join", "p4"),
    (256, 1, 1),
    (512, 3, 1),
    (256, 1, 1),
    (512, 3, 1),
    (256, 1, 1),  # N4
    ("head", 1.1),  # stride 16
    (512, 3, 2),
    ("join", "p5"),
    (512, 1, 1),
    (1024, 3, 1),
    (512, 1, 1),
    (1024, 3, 1),
    (512, 1, 1),  # N5
    ("head", 1.05),  # stride 32
)

# YOLOv7 (Wang, Bochkovskiy and Liao, arXiv:2207.02696), layers 0-105 of
# yolov7.yaml in the deploy form of cfg/deploy/yolov7.yaml: the stem, four
# ELANs with MP down-sampling between them (C3, C4 saved), SPPCSPC (P5),
# the top-down path (a lateral 1x1 on C4, then on C3, each concatenated
# with the upsampled trunk, each followed by an ELAN-H) and the bottom-up
# path (MP joined with P4, then with P5, each followed by an ELAN-H); heads
# finest first, each RepConv + IDetect, folded, with the squared-size
# decode. ``strides=(8, 16, 32)``, ``config.YOLOV7_ANCHORS``, ``silu``.
YOLOV7_LAYER_CONFIG = (
    (32, 3, 1),
    (64, 3, 2),
    (64, 3, 1),
    (128, 3, 2),
    ("elan", 64, 64, 256),
    ("mp", 128),
    ("elan", 128, 128, 512),
    ("save", "c3"),
    ("mp", 256),
    ("elan", 256, 256, 1024),
    ("save", "c4"),
    ("mp", 512),
    ("elan", 256, 256, 1024),
    ("sppcspc", 512),
    ("save", "p5"),
    (256, 1, 1),
    ("lateral", "c4", 256),
    ("elanh", 256, 128, 256),
    ("save", "p4"),
    (128, 1, 1),
    ("lateral", "c3", 128),
    ("elanh", 128, 64, 128),
    ("head", 2.0, "square"),  # stride 8
    ("mp", 128, "p4"),
    ("elanh", 256, 128, 256),
    ("head", 2.0, "square"),  # stride 16
    ("mp", 256, "p5"),
    ("elanh", 512, 256, 512),
    ("head", 2.0, "square"),  # stride 32
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
    # the decode's cell-offset scale, 1.0 for YOLOv3 (no field: the entry's
    # fields are the JAX package's); PlanGridHead's is a field
    scale_xy: ClassVar[float] = 1.0
    # how the decode reads the size logits: ``exp(t) * anchor``, or
    # PlanRepHead's ``(2 sigmoid(t))^2 * anchor``
    size_decode: ClassVar[str] = "exp"

    @property
    def mid(self) -> int:
        return self.mid_ch if self.mid_ch is not None else 2 * self.in_ch


@dataclasses.dataclass(frozen=True)
class PlanGridHead(PlanHead):
    """A YOLOv4 head: its decode is grid-sensitive, a cell's offset
    ``sigmoid(t) * scale_xy - (scale_xy - 1) / 2`` (darknet's
    ``scale_x_y``)."""

    scale_xy: float = 1.0
    family: ClassVar[str] = "YOLOv4"
    label: ClassVar[str] = "grid-sensitive heads"


@dataclasses.dataclass(frozen=True)
class PlanRepHead(PlanGridHead):
    """A YOLOv7 head: grid-sensitive, and its sizes decode as ``(2
    sigmoid(t))^2 * anchor``; trainable as RepConv and IDetect's implicit
    1x1 (``TrainableRepHead``), folded as ``Head``'s 3x3 and 1x1."""

    size_decode: ClassVar[str] = "square"
    family: ClassVar[str] = "YOLOv7"
    label: ClassVar[str] = "RepConv heads"


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


@dataclasses.dataclass(frozen=True)
class PlanActivation:
    """The activation of every conv and head after it (YOLOv4: leaky after
    the mish backbone)."""

    name: str
    family: ClassVar[str] = "YOLOv4"
    label: ClassVar[str] = "activation switches"


@dataclasses.dataclass(frozen=True)
class PlanSPP:
    """Spatial pyramid pooling: stride-1 SAME max pools, concatenated as
    ``[pool(largest), ..., pool(smallest), x]``."""

    in_ch: int
    kernels: Tuple[int, ...] = (5, 9, 13)
    family: ClassVar[str] = "YOLOv4"
    label: ClassVar[str] = "SPP"


@dataclasses.dataclass(frozen=True)
class PlanSave:
    """Save the trunk as the route ``name``."""

    name: str
    family: ClassVar[str] = "YOLOv4"
    label: ClassVar[str] = "named routes"


@dataclasses.dataclass(frozen=True)
class PlanLateral:
    """A 1x1 conv (+ activation) on the saved route ``route`` (``in_ch``
    channels) to ``out_ch``, concatenated with the upsampled trunk:
    ``[lateral, upsampled]``."""

    route: str
    in_ch: int
    out_ch: int
    family: ClassVar[str] = "YOLOv4"
    label: ClassVar[str] = "named routes"


@dataclasses.dataclass(frozen=True)
class PlanJoin:
    """Channel concat of the trunk with the saved route ``route``:
    ``[trunk, route]`` (PANet's bottom-up path)."""

    route: str
    family: ClassVar[str] = "YOLOv4"
    label: ClassVar[str] = "named routes"


# the families whose entries only the folded and the trainable walk take,
# each with its article; a plan is named after the last family it holds
# (a YOLOv7 plan holds YOLOv4's named routes too)
FAMILIES = {"YOLOv4": "a YOLOv4", "YOLOv7": "a YOLOv7", "RT-DETR": "an RT-DETR"}


def refuse_walk_only(plan, path: str, missing: str, families=tuple(FAMILIES)) -> None:
    """Raise a ValueError when ``plan`` has entries that only the folded and
    the trainable walk take: YOLOv4's, YOLOv7's and RT-DETR's, each marked
    by its ``family`` and ``label``, which neither int8 PTQ, spatial
    partitioning, the darknet reader nor the Trainer take (bundles and
    exports refuse RT-DETR's alone: ``families``). The message names
    ``path``, the plan's family, the entries' labels and ``missing``, what
    ``path`` would need."""
    found = [e for e in plan if getattr(e, "family", None)]
    if any(e.family in families for e in found):
        family = max((e.family for e in found), key=list(FAMILIES).index)
        labels = ", ".join(dict.fromkeys(e.label for e in found))
        raise ValueError(f"{path} does not take {FAMILIES[family]} plan ({labels}): {missing}")


Plan = Tuple


def build_plan(cfg: ModelConfig, layer_config=None) -> Plan:
    """Walk the layer DSL into a static plan (reference: code/model.py:195-225).

    The DSL is ``cfg.layer_config`` when set, else ``layer_config`` when
    given, else the backbone's: ``CSP_LAYER_CONFIG`` for ``cspdarknet53``,
    ``build_tiny_plan`` for ``yolov3_tiny``, ``YOLOV4_LAYER_CONFIG`` for
    ``yolov4``, ``YOLOV7_LAYER_CONFIG`` for ``yolov7`` and ``LAYER_CONFIG``
    for any other name, as ``YOLOv3.plan`` of the JAX package chooses
    (which has neither ``yolov4`` nor ``yolov7``).

    Entries: ``(out, k, stride)`` a conv; ``("B", n)`` a residual stage and
    ``("C", n)`` a CSP stage (8-block stages save a LIFO route); ``"S"``
    YOLOv3's five-conv set and head; ``"U"`` an upsample concatenated with
    the last LIFO route. YOLOv4's: ``("act", name)``, ``("spp", *kernels)``,
    ``("save", name)``, ``("lateral", route, out)``, ``("join", route)``
    and ``("head", scale_xy)``, a head alone on the trunk. YOLOv7's:
    ``("elan", mid, q, out)`` / ``("elanh", mid, q, out)``, ``("mp", c)`` /
    ``("mp", c, route)``, ``("sppcspc", c)`` and ``("head", scale_xy,
    "square")`` (``models/yolov7.py``). RT-DETR's (``rtdetr_r50vd``,
    ``RTDETR_LAYER_CONFIG``): ``("resnet_vd", width, *depths)``,
    ``("hybrid_encoder", hidden, heads, ffn, blocks)`` and
    ``("detr_decoder", hidden, heads, levels, points, queries, layers,
    ffn)`` (``models/rtdetr.py``), each handing its levels to the next."""
    if cfg.layer_config is not None:
        layer_config = cfg.layer_config
    elif layer_config is None:
        if cfg.backbone == "yolov3_tiny":
            from .yolov3_tiny import build_tiny_plan

            return build_tiny_plan(cfg)
        layer_config = {"cspdarknet53": CSP_LAYER_CONFIG,
                        "yolov4": YOLOV4_LAYER_CONFIG,
                        "yolov7": YOLOV7_LAYER_CONFIG,
                        "rtdetr_r50vd": RTDETR_LAYER_CONFIG}.get(cfg.backbone, LAYER_CONFIG)
    plan: List = []
    in_ch = cfg.in_channels
    first_csp = True
    saved = {}  # channels of each named route
    for block in layer_config:
        tag = block[0] if isinstance(block, tuple) else block
        detr = rtdetr.plan_entry(block, in_ch, cfg.num_classes) if isinstance(tag, str) else None
        if detr is not None:
            entry, in_ch = detr
            plan.append(entry)
        elif tag == "B":
            n = block[1]
            plan.append(
                PlanResidual(channels=in_ch, num_blocks=n, save_route=(n == 8))
            )
        elif tag == "C":
            n = block[1]
            plan.append(PlanCSP(channels=in_ch, num_blocks=n, save_route=(n == 8),
                                first_stage=first_csp))
            first_csp = False
        elif tag == "act":
            get_activation(block[1])  # an unknown name raises here
            plan.append(PlanActivation(block[1]))
        elif tag == "spp":
            plan.append(PlanSPP(in_ch, tuple(block[1:])))
            in_ch *= len(block)
        elif tag == "save":
            plan.append(PlanSave(block[1]))
            saved[block[1]] = in_ch
        elif tag == "lateral":
            _, route, out_ch = block
            plan.append(PlanLateral(route, saved[route], out_ch))
            in_ch += out_ch
        elif tag == "join":
            plan.append(PlanJoin(block[1]))
            in_ch += saved[block[1]]
        elif tag == "head":
            if block[2:] not in ((), ("square",)):
                raise ValueError(f"Unknown head decode in {block!r}")
            head = PlanRepHead if block[2:] else PlanGridHead
            plan.append(head(in_ch, cfg.num_classes, cfg.anchors_per_scale,
                             scale_xy=float(block[1])))
        elif tag in ELAN_PICKS:
            _, mid, q, out_ch = block
            plan.append(PlanELAN(in_ch, mid, q, out_ch, ELAN_PICKS[tag]))
            in_ch = out_ch
        elif tag == "mp":
            route = block[2] if len(block) > 2 else None
            plan.append(PlanMP(in_ch, block[1], route))
            in_ch = 2 * block[1] + (saved[route] if route is not None else 0)
        elif tag == "sppcspc":
            plan.append(PlanSPPCSPC(in_ch, block[1]))
            in_ch = block[1]
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
    return 0 if params is None else int(np.prod(np.shape(params)))


def jax_layout(w: torch.Tensor, b: torch.Tensor) -> dict:
    """An OIHW conv weight and its bias as the JAX tree's {"w": HWIO, "b"}
    numpy float32 arrays; a linear layer's (out, in) weight or a layer
    norm's scale as it is."""
    w = w.detach().float().cpu()
    w = w.permute(2, 3, 1, 0) if w.dim() == 4 else w  # OIHW -> HWIO
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
        self.blocks = residual_blocks(c, c // 2, entry.num_blocks,
                                      lambda *shape: ConvBlock(*shape, generator=generator))

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
        self.conv1, self.conv2 = self._convs(entry.in_ch, entry.mid, out_ch, generator)

    @staticmethod
    def _convs(in_ch: int, mid: int, out_ch: int, generator):
        return (ConvBlock(in_ch, mid, 3, generator=generator),
                ConvBlock(mid, out_ch, 1, bn=False, generator=generator))

    def forward(self, x, act, rows=None):
        return self.conv2(self.conv1(x, act, rows), rows=rows)


class TrainableRepHead(TrainableHead):
    """YOLOv7's head in its training form: RepConv + activation, then
    IDetect's implicit 1x1; ``fold()`` gives ``Head``'s 3x3 and 1x1."""

    @staticmethod
    def _convs(in_ch: int, mid: int, out_ch: int, generator):
        return (RepConvBlock(in_ch, mid, generator=generator),
                ImplicitConv(mid, out_ch, generator=generator))


class YOLOv3(nn.Module):
    """The trainable model: conv + BN + activation per layer.

    ``forward`` takes an NHWC image batch and returns one head per scale,
    in the order of ``strides``, each ``(B, A, S, S, 5+C)`` float32: the
    counterpart of ``apply(..., train=self.training)``. Train mode normalizes with the
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
        self.layers = plan_layers(self.plan, folded=False, generator=generator)
        self._parts = _parts(self.plan, self.layers)

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
        return conv_trees(self.layers, lambda block: jax_layout(**block.folded()))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class ResidualStage(nn.Module):
    """A stack of folded residual blocks (1x1 halve, 3x3 restore)."""

    def __init__(self, entry: PlanResidual):
        super().__init__()
        c = entry.channels
        self.entry = entry
        self.blocks = residual_blocks(c, c // 2, entry.num_blocks, FoldedConv)
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


# ---------------------------------------------------------------------------
# The layers of a plan, and the JAX tree of their convs
# ---------------------------------------------------------------------------

# Each plan entry type's (trainable layer, folded layer): factories of
# (entry, generator) and of (entry). An entry without weights is an
# nn.Identity in both (it takes and ignores any arguments).
LAYERS = {
    PlanConv: (lambda e, g: ConvBlock(e.in_ch, e.out_ch, e.kernel, e.stride, bn=e.bn,
                                      generator=g),
               lambda e: FoldedConv(e.in_ch, e.out_ch, e.kernel, e.stride)),
    PlanLateral: (lambda e, g: ConvBlock(e.in_ch, e.out_ch, 1, generator=g),
                  lambda e: FoldedConv(e.in_ch, e.out_ch, 1)),
    PlanResidual: (TrainableResidualStage, ResidualStage),
    PlanCSP: (TrainableCSPStage, CSPStage),
    PlanHead: (TrainableHead, Head),
    PlanGridHead: (TrainableHead, Head),
    PlanRepHead: (TrainableRepHead, Head),
    **{entry: (lambda e, g, block=block: block(e, lambda *shape: ConvBlock(*shape, generator=g)),
               lambda e, block=block: block(e, FoldedConv))
       for entry, block in ((PlanELAN, ELAN), (PlanMP, MPDown), (PlanSPPCSPC, SPPCSPC))},
    **{entry: (lambda e, g: rtdetr.layer(e, rtdetr.trainable_kit(g)),
               lambda e: rtdetr.layer(e, rtdetr.FOLDED_KIT))
       for entry in DETR_ENTRIES},
    **{t: (nn.Identity, nn.Identity)
       for t in (PlanUpsample, PlanMaxPool, PlanRoute, PlanActivation, PlanSPP, PlanSave,
                 PlanJoin)},
}


def plan_layers(plan: Plan, folded: bool, generator=None) -> nn.ModuleList:
    """One layer per plan entry, from ``LAYERS``: the folded ones, or the
    trainable ones with their weights drawn from ``generator``."""
    layers = []
    for entry in plan:
        if type(entry) not in LAYERS:
            raise TypeError(f"unknown plan entry {entry!r}")
        trainable, fold = LAYERS[type(entry)]
        layers.append(fold(entry) if folded else trainable(entry, generator))
    return nn.ModuleList(layers)


# the modules that are leaves of the weight trees
WEIGHT_LEAVES = (ConvBlock, FoldedConv, Linear, LayerNorm)


def conv_paths(layers) -> Iterator[Tuple[int, tuple, nn.Module]]:
    """``(entry index, key path, conv)`` for every conv (``ConvBlock`` or
    ``FoldedConv``) of ``layers``, and every ``Linear`` and ``LayerNorm``
    (RT-DETR's), in registration order, which is the JAX
    init order (a CSP stage: split1, split2, the blocks, transition, fuse).
    The JAX tree holds the conv at that path of entry ``index``'s tree: the
    conv's own name in its layer (``blocks.3.conv1`` -> ``("blocks", 3,
    "conv1")``), and ``("conv",)`` for a layer that is itself a conv."""
    for i, layer in enumerate(layers):
        for name, module in layer.named_modules():
            if isinstance(module, WEIGHT_LEAVES):
                path = tuple(int(k) if k.isdigit() else k for k in name.split("."))
                yield i, path if name else ("conv",), module


def tree_leaf(tree, path: tuple):
    """The leaf of a nested dict / list tree at ``path``."""
    for key in path:
        try:
            tree = tree[key]
        except (KeyError, IndexError, TypeError):
            raise ValueError(f"no leaf at path {path}") from None
    return tree


def tree_insert(tree, path: tuple, leaf) -> None:
    """Put ``leaf`` at ``path`` of a nested dict / list tree, making a dict
    under each str key and a list under each int key on the way; the ints of
    a list come in order (each appends), dict keys in insertion order."""
    for depth, key in enumerate(path):
        new = (leaf if depth == len(path) - 1
               else [] if isinstance(path[depth + 1], int) else {})
        if isinstance(tree, list):
            if key == len(tree):
                tree.append(new)
        else:
            tree.setdefault(key, new)
        tree = tree[key]


def conv_trees(layers, fn) -> list:
    """The JAX tree of ``layers``: ``fn(conv)`` at each conv's path, ``{}``
    for an entry without weights."""
    trees = [{} for _ in layers]
    for i, path, conv in conv_paths(layers):
        tree_insert(trees[i], path, fn(conv))
    return trees


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


def _init_leaf(gen, module):
    """A linear layer's weight and bias U(-1/sqrt(in), 1/sqrt(in)) (torch's
    init); a layer norm's scale 1 and shift 0."""
    if isinstance(module, LayerNorm):
        return {"w": torch.ones(module.weight.shape), "b": torch.zeros(module.bias.shape)}
    out_ch, in_ch = module.weight.shape
    bound = 1.0 / math.sqrt(in_ch)
    return {"w": (torch.rand(out_ch, in_ch, generator=gen) * 2 - 1) * bound,
            "b": (torch.rand(out_ch, generator=gen) * 2 - 1) * bound}


def init_plan(plan: Plan, generator: torch.Generator):
    """Random folded tree aligned with a plan, in the layout of the JAX
    ``fold_params`` output (HWIO weights), as CPU float32 tensors."""
    # the folded layers on the meta device: their convs' paths and shapes,
    # no memory
    with torch.device("meta"):
        layers = plan_layers(plan, folded=True)
    folded = [{} for _ in plan]
    for i, path, conv in conv_paths(layers):
        if isinstance(conv, (Linear, LayerNorm)):
            tree_insert(folded[i], path, _init_leaf(generator, conv))
            continue
        out_ch, in_ch, kernel, _ = conv.weight.shape
        # BN-free: a head's last 1x1 (its tree's top-level "conv2") and a
        # PlanConv with bn=False
        bn = getattr(plan[i], "bn", True) and path != ("conv2",)
        tree_insert(folded[i], path, _init_folded_conv(generator, in_ch, out_ch, kernel, bn))
    return folded


class FoldedYOLOv3(nn.Module):
    """Folded-BN inference forward with raw heads.

    ``forward`` takes an NHWC image batch in [0, 1] and returns one raw head
    per scale, in the order of ``strides``, each NHWC ``(B, S, S,
    A*(5+C))`` in the module's dtype (``apply_inference(...,
    raw_heads=True)``). Inside, the trunk runs NCHW; with
    ``memory_format=torch.channels_last`` weights the activations are NHWC
    in memory, which is what the fused residual kernel and K5 take (the
    concats, pools and upsamples keep it). On a YOLOv4 plan the forward
    runs in three spans (``_parts``); on a YOLOv7 plan each ELAN and the
    SPPCSPC run in a span of their own (``_walk``). An RT-DETR plan's
    forward returns ``[logits, boxes, memory, idx]`` instead of heads
    (``models/rtdetr.py``).
    """

    def __init__(self, cfg: ModelConfig, plan: Optional[Plan] = None):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg) if plan is None else plan
        self.layers = plan_layers(self.plan, folded=True)
        self._parts = _parts(self.plan, self.layers)
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


_NO_SPAN = contextlib.nullcontext()


def _parts(plan, layers) -> tuple:
    """The walk's ``(span name, ((entry, layer), ...))`` parts: a plan with
    SPP in three, ``forward.backbone`` (everything before SPP: the stem,
    the stages to C5 and the three convs that feed SPP), ``forward.spp``
    (the pools and their concat, one ``maxpool_pyramid``) and
    ``forward.neck`` (the rest, the heads included); any other plan in one
    part that opens no span."""
    pairs = tuple(zip(plan, layers))
    at = next((i for i, e in enumerate(plan) if isinstance(e, PlanSPP)), None)
    if at is None:
        return ((None, pairs),)
    return (("forward.backbone", pairs[:at]), ("forward.spp", pairs[at : at + 1]),
            ("forward.neck", pairs[at + 1 :]))


def _walk(model, x, layout, act, stage, head) -> List[torch.Tensor]:
    """The plan's walk, shared by both modules: NHWC ``x`` in, one head per
    scale out in the plan's order (``head(entry, NCHW y)``); ``stage(layer,
    x, rows)`` runs a residual or CSP stage. Routes are saved at the
    8-block stages and at a ``PlanRoute`` and popped LIFO after each
    upsample (a concat ``[upsampled, route]``); a ``PlanSave`` saves one by
    name, which a ``PlanLateral`` or ``PlanJoin`` reads; a head is a
    branch. Each part of ``model._parts`` runs inside its span (a YOLOv4
    plan's three; none for any other plan); each ``PlanELAN`` runs inside
    ``forward.elan`` and each ``PlanSPPCSPC`` inside ``forward.sppcspc``, a
    ``PlanMP`` joins its named route; RT-DETR's entries hand their levels
    on, each inside its span (``detr.backbone``, ``detr.encoder``,
    ``detr.decoder``), and the decoder's outputs are the result. Every max
    pool runs inside a span ``forward.pool`` of its own.

    Every channel concat is a ``blocks.ChannelConcat``: on the folded
    model's card route its buffer is allocated first and each part written
    into it, the lateral 1x1 by K5 and the conv before a ``PlanJoin`` too
    (the trunk part), the upsampled trunk and the saved routes by a copy;
    elsewhere ``torch.cat``. Its bytes are counted in
    ``utils/profiling.py::concat_bytes`` (copy passes) and
    ``concat_in_place_bytes`` (K5's stores), but for SPP's and SPPCSPC's
    pool pyramids on the card, which K8 writes without a concat
    (``blocks.maxpool_pyramid``).

    With a ``layout``, ``rows`` says how each activation lies on the mesh;
    ``layout.constrain`` re-lays it where the height changes (the JAX
    ``constrain`` points) and the heads are gathered. A YOLOv4, YOLOv7 or
    RT-DETR plan takes no layout."""
    x = x.to(next(model.parameters()).dtype).permute(0, 3, 1, 2)
    rows = None
    if layout is not None:
        refuse_walk_only(model.plan, "spatial partitioning",
                         "no halo rule for these entries is ported")
        x, rows = layout.enter(x)
    preds: List[torch.Tensor] = []
    routes: List[torch.Tensor] = []
    named = {}
    folded = isinstance(model, FoldedYOLOv3)
    join = None  # the next PlanJoin's concat, its trunk part written by the conv before it
    for name, part in model._parts:
        with _NO_SPAN if name is None else span(name):
            for i, (entry, layer) in enumerate(part):
                following = part[i + 1][0] if i + 1 < len(part) else None
                if isinstance(entry, PlanConv) and isinstance(following, PlanJoin) and (
                        rows is None):
                    route = named[following.route]
                    join = ChannelConcat(x, act, (entry.out_ch, route.shape[1]),
                                         route.shape[2:], folded)
                    x = join.conv(0, layer, x, act)
                elif isinstance(entry, (PlanConv, PlanMaxPool)):
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
                    route = routes.pop().to(x.dtype)
                    cat = ChannelConcat(x, act, (x.shape[1], route.shape[1]), route.shape[2:],
                                        folded, rows)
                    if rows is None:
                        cat.upsampled(0, x)
                    else:
                        # the route was laid out at this height by the same rule
                        x, rows = layout.constrain(upsample2x(x), rows)
                        cat.put(0, x)
                    cat.put(1, route)
                    x = cat.result()
                elif isinstance(entry, PlanSave):
                    named[entry.name] = x
                elif isinstance(entry, PlanActivation):
                    act = get_activation(entry.name)
                elif isinstance(entry, PlanSPP):
                    x = maxpool_pyramid(x, tuple(reversed(entry.kernels)) + (1,))
                elif isinstance(entry, PlanLateral):
                    route = named[entry.route]
                    cat = ChannelConcat(route, act, (entry.out_ch, x.shape[1]), route.shape[2:],
                                        folded)
                    cat.conv(0, layer, route, act)
                    cat.upsampled(1, x)
                    x = cat.result()
                elif isinstance(entry, PlanJoin):
                    route = named[entry.route]
                    if join is None:  # no conv just before it to write the trunk part
                        join = ChannelConcat(x, act, (x.shape[1], route.shape[1]),
                                             route.shape[2:], folded)
                        join.put(0, x)
                    join.put(1, route)
                    x, join = join.result(), None
                elif isinstance(entry, PlanELAN):
                    with span("forward.elan"):
                        x = layer(x, act)
                elif isinstance(entry, PlanMP):
                    x = layer(x, act, None if entry.route is None else named[entry.route])
                elif isinstance(entry, PlanSPPCSPC):
                    with span("forward.sppcspc"):
                        x = layer(x, act)
                elif isinstance(entry, DETR_ENTRIES):
                    with span(entry.span):
                        x = layer(x)
                    if isinstance(entry, PlanDETRDecoder):
                        preds.extend(x)  # logits, boxes, memory, idx
    return preds
