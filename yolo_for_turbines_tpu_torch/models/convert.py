"""Weight bridge: the JAX ``(params, batch_stats)`` trees -> the trainable
module, a folded tree in the JAX layout -> the folded module, and back; the
JAX package's int8 tree -> the port's ``qparams``.

The JAX trees are plan-aligned lists of ``{"conv": ...}``, ``{"blocks":
[{"conv1", "conv2"}, ...]}``, ``{"conv1", "conv2"}`` (a head), ``{"split1",
"split2", "blocks", "transition", "fuse"}`` (a CSP stage) and ``{}`` (an
upsample, max pool or route) entries with HWIO weights. A trainable conv holds ``{w, scale, bias}`` and
its stats ``{mean, var}``; a head's last 1x1 holds ``{w, b}`` and its stats
are None; each block names its own leaves (``ConvBlock.leaves`` and
``stat_leaves``: YOLOv7's RepConv and implicit 1x1, which the JAX package
lacks, add theirs to these). ``fold_params`` (``models/yolov3.py``) gives ``{w, b}`` for every
conv. Leaves may be numpy arrays (also bf16 ones), torch tensors, or
anything ``np.asarray`` takes. Both packages then compute the same function
from the same numbers. ``qparams_to_numpy`` gives the port's int8 tree back
in the JAX layout, for the bundle writer (``serving.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from .blocks import ConvBlock
from .cspdarknet import SINGLE_CONVS, PlanCSP, conv_shapes
from .yolov3 import (
    FoldedYOLOv3,
    Plan,
    PlanConv,
    PlanHead,
    PlanMaxPool,
    PlanResidual,
    PlanRoute,
    PlanUpsample,
    YOLOv3,
    conv_paths,
    conv_trees,
    jax_layout,
    param_count,
    tree_leaf,
)


def _to_f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@torch.no_grad()
def _fill(conv, p) -> None:
    """A ``FoldedConv`` or ``nn.Conv2d`` from ``{"w": HWIO, "b"}``; a conv
    without a bias takes ``w`` alone; a ``Linear`` or ``LayerNorm`` takes
    its ``w`` as it is."""
    w = _to_f32(p["w"])
    w = w.permute(3, 2, 0, 1) if w.dim() == 4 else w  # HWIO -> OIHW
    if tuple(w.shape) != tuple(conv.weight.shape):
        raise ValueError(f"weight {tuple(w.shape)} != module {tuple(conv.weight.shape)}")
    conv.weight.copy_(w)
    if conv.bias is not None:
        conv.bias.copy_(_to_f32(p["b"]))


def folded_from_numpy(plan: Plan, folded, cfg: ModelConfig) -> FoldedYOLOv3:
    """Build the module for ``plan`` and fill it from a folded tree.

    ``cfg`` supplies the activation and the ``fuse_resblocks`` switch; the
    plan must be ``build_plan(cfg)`` of the model the tree was folded from.
    """
    model = FoldedYOLOv3(cfg, plan)
    if len(folded) != len(plan):
        raise ValueError(f"folded tree has {len(folded)} entries, plan {len(plan)}")
    for i, path, conv in conv_paths(model.layers):
        _fill(conv, tree_leaf(folded, (i, *path)))
    if param_count(folded) != param_count(model):  # leaves the module lacks: more blocks
        raise ValueError(f"folded tree holds {param_count(folded)} weights, plan "
                         f"{param_count(model)}")
    return model


def folded_to_numpy(model: FoldedYOLOv3) -> list:
    """Inverse of :func:`folded_from_numpy`: the module's weights as a folded
    tree in the JAX layout (HWIO), numpy in the weights' own precision
    (f32 unless the module was cast)."""
    return conv_trees(model.layers, lambda conv: jax_layout(conv.weight, conv.bias))


@torch.no_grad()
def _fill_trainable(block: ConvBlock, p, s) -> None:
    """A trainable block's leaves from its params and stats nodes (kernels
    HWIO)."""
    for leaves, node in ((block.leaves(), p), (block.stat_leaves() or {}, s)):
        for k, t in leaves.items():
            v = _to_f32(node[k])
            v = v.permute(3, 2, 0, 1) if v.dim() == 4 else v  # HWIO -> OIHW
            if tuple(v.shape) != tuple(t.shape):
                what = "weight" if t.dim() == 4 else k
                raise ValueError(f"{what} {tuple(v.shape)} != module {tuple(t.shape)}")
            t.copy_(v)


def trainable_from_numpy(plan: Plan, params, batch_stats, cfg: ModelConfig, *,
                         device) -> YOLOv3:
    """The trainable module for ``plan`` on ``device``, filled from the JAX
    ``(params, batch_stats)`` trees (``YOLOv3.init`` or a trained state).

    ``cfg`` supplies the activation; the plan must be ``build_plan(cfg)`` of
    the model the trees belong to."""
    model = YOLOv3(cfg, plan, generator=torch.Generator().manual_seed(0))
    load_trainable(model, params, batch_stats)
    return model.to(device)


def load_trainable(model: YOLOv3, params, batch_stats) -> None:
    """Overwrite the trainable module's weights and running statistics, in
    place and on its device, from the JAX ``(params, batch_stats)`` trees of
    its plan."""
    if not len(params) == len(batch_stats) == len(model.plan):
        raise ValueError(f"trees have {len(params)} and {len(batch_stats)} entries, "
                         f"plan {len(model.plan)}")
    for i, path, block in conv_paths(model.layers):
        _fill_trainable(block, tree_leaf(params, (i, *path)), tree_leaf(batch_stats, (i, *path)))
    if param_count(params) != param_count(model):  # leaves the module lacks: more blocks
        raise ValueError(f"params tree holds {param_count(params)} weights, plan "
                         f"{param_count(model)}")


def trainable_to_numpy(model: YOLOv3):
    """Inverse of :func:`trainable_from_numpy`: ``(params, batch_stats)``
    trees in the JAX layout (HWIO), numpy float32 copies."""

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t  # OIHW -> HWIO
        # a copy: .numpy() of a CPU f32 tensor would alias the live weights
        return t.detach().to("cpu", torch.float32, copy=True).contiguous().numpy()

    def node(leaves):
        return None if leaves is None else {k: arr(t) for k, t in leaves.items()}

    return (conv_trees(model.layers, lambda block: node(block.leaves())),
            conv_trees(model.layers, lambda block: node(block.stat_leaves())))


def _leaf(a, device) -> torch.Tensor:
    """int8 stays int8, every other array becomes f32, on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = torch.from_numpy(np.array(a if a.dtype == np.int8 else a.astype(np.float32)))
    return a.detach().to(device, torch.int8 if a.dtype == torch.int8 else torch.float32)


def _check_shape(t: torch.Tensor, shape, what: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"quantized {what}: shape {tuple(t.shape)}, plan says {tuple(shape)}")
    return t


def _q_conv(p, in_ch: int, out_ch: int, k: int, device, what: str) -> dict:
    """One quantized conv ``{wq, sw, b}`` on ``device``, shapes checked."""
    return {
        "wq": _check_shape(_leaf(p["wq"], device), (k, k, in_ch, out_ch), f"{what} weight"),
        "sw": _check_shape(_leaf(p["sw"], device), (out_ch,), f"{what} scale"),
        "b": _check_shape(_leaf(p["b"], device), (out_ch,), f"{what} bias"),
    }


def qparams_from_numpy(plan: Plan, qtree, device) -> dict:
    """The JAX package's quantized tree -> the port's ``qparams`` on ``device``.

    ``qtree`` is ``models/quantize.py::quantize_folded`` output (or its
    bundle copy): ``{"layers": [...], "scales": (n,)}`` with HWIO int8
    weights ``wq`` / ``w1q`` / ``w2q``, f32 per-channel scales ``sw`` /
    ``s1`` / ``s2`` and biases, and full-precision head weights. Leaves may
    be numpy arrays, jax arrays or tensors. The result has the same
    structure with int8 and f32 tensors, so both packages compute from the
    same int8 numbers."""
    layers = qtree["layers"]
    if len(layers) != len(plan):
        raise ValueError(f"quantized tree has {len(layers)} entries, plan {len(plan)}")
    out = []
    for entry, p in zip(plan, layers):
        if isinstance(entry, PlanConv):
            out.append(_q_conv(p, entry.in_ch, entry.out_ch, entry.kernel, device, "conv"))
        elif isinstance(entry, PlanResidual):
            c, ch = entry.channels, entry.channels // 2
            if len(p["blocks"]) != entry.num_blocks:
                raise ValueError("quantized residual stage block count differs from the plan")
            want = {"w1q": (1, 1, c, ch), "s1": (ch,), "b1": (ch,),
                    "w2q": (3, 3, ch, c), "s2": (c,), "b2": (c,)}
            out.append({"blocks": [
                {k: _check_shape(_leaf(bp[k], device), s, f"block {k}") for k, s in want.items()}
                for bp in p["blocks"]
            ]})
        elif isinstance(entry, PlanCSP):
            shapes = conv_shapes(entry)
            if len(p["blocks"]) != entry.num_blocks:
                raise ValueError("quantized CSP stage block count differs from the plan")
            stage = {k: _q_conv(p[k], *shapes[k], device, k) for k in SINGLE_CONVS}
            (bc, hc, _), (_, _, k2) = shapes["conv1"], shapes["conv2"]
            want = {"w1q": (1, 1, bc, hc), "s1": (hc,), "b1": (hc,),
                    "w2q": (k2, k2, hc, bc), "s2": (bc,), "b2": (bc,)}
            stage["blocks"] = [
                {k: _check_shape(_leaf(bp[k], device), s, f"CSP block {k}")
                 for k, s in want.items()}
                for bp in p["blocks"]
            ]
            out.append(stage)
        elif isinstance(entry, PlanHead):
            out.append({k: {"w": _leaf(p[k]["w"], device), "b": _leaf(p[k]["b"], device)}
                        for k in ("conv1", "conv2")})
        elif isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
            out.append({})
        else:
            raise TypeError(f"unknown plan entry {entry!r}")
    scales = _leaf(qtree["scales"], device)
    if scales.dim() != 1:
        raise ValueError(f"quantized scales must be a vector, got {tuple(scales.shape)}")
    return {"layers": out, "scales": scales}


# the JAX package's key order of a quantized CSP stage (``quantize_folded``;
# its heads pass through ``tree_map``, which sorts keys): a bundle's spec and
# npz keys follow the tree's order
_Q_CSP_KEYS = ("split1", "split2", "blocks", "transition", "fuse")


def qparams_to_numpy(plan: Plan, qparams) -> dict:
    """Inverse of :func:`qparams_from_numpy`: the port's ``qparams`` as the
    JAX package's quantized tree, numpy on the host, in its structure and
    key order: int8 codes, f32 scales and biases, f32 head weights, ``{}``
    for the weightless entries and an f32 ``scales`` vector. The bundle
    writer stores it as ``quantized.npz``."""

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [host(v) for v in t]
        return t.detach().to("cpu").numpy().copy()

    layers = qparams["layers"]
    if len(layers) != len(plan):
        raise ValueError(f"quantized tree has {len(layers)} entries, plan {len(plan)}")
    out = []
    for entry, p in zip(plan, layers):
        if isinstance(entry, PlanCSP):
            p = {k: p[k] for k in _Q_CSP_KEYS}
        elif isinstance(entry, PlanHead):
            p = {k: dict(sorted(p[k].items())) for k in ("conv1", "conv2")}
        out.append(host(p))
    return {"layers": out, "scales": host(qparams["scales"])}
