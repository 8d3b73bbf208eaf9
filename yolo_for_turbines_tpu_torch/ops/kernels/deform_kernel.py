"""The sampling core of multi-scale deformable attention (kernel K9,
``csrc/deform.cu``), and its plain torch version.

K9 replaces no TPU kernel: the JAX package has no deformable attention. It
computes RT-DETR's ``deformable_attention_core_func`` (Deformable DETR,
arXiv:2010.04159) in one pass:

    out[b, q, h * D + c] = sum over levels l and points p of
        w[b, q, h, l, p] * bilinear(value_l[b, :, :, h * D + c], loc[b, q, h, l, p])

with ``bilinear`` grid_sample's (``align_corners=False``, zero padding) at
the grid ``2 loc - 1``: the bf16 values read where they lie in the memory,
the locations and weights in float32, the sum in float32, rounded once to
bf16. ``deform_attention`` dispatches on the value's device: a CPU tensor
takes ``deform_attention_reference``; a CUDA tensor launches the kernel
(bf16 only) or raises. ``models/rtdetr.py::MSDeformableAttention`` sends it
what it takes (``deform_wins``) and keeps the plain version for every other
input.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import check, load_library, stream_handle

# kernel launches since the last reset (read by chip_smoke.py and the card
# tests)
launches = 0

MAX_LEVELS = 4


def deform_attention_reference(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                               loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain torch version, (B, Q, heads * D) float32: the source's
    ``deformable_attention_core_func``. ``value`` (B, N, heads * D), ``loc``
    (B, Q, heads, levels, points, 2) float32 in [0, 1] and ``weights`` (B,
    Q, heads, levels * points) float32. Each level's values go to float32
    (B * heads, D, h, w) stored channels-last, so that ``grid_sample`` takes
    them beside the float32 grid and a sample reads D consecutive
    numbers."""
    b, n, c = value.shape
    _, q, hd, lv, pt, _ = loc.shape
    d = c // hd
    grids = (2 * loc - 1).permute(0, 2, 3, 1, 4, 5).reshape(b * hd, lv, q, pt, 2)
    sampled, at = [], 0
    for lvl, (h, w) in enumerate(shapes):
        v = torch.empty((b, hd, h, w, d), dtype=torch.float32, device=value.device)
        v.copy_(value[:, at : at + h * w].view(b, h, w, hd, d).permute(0, 3, 1, 2, 4))
        v = v.view(b * hd, h, w, d).permute(0, 3, 1, 2)
        sampled.append(F.grid_sample(v, grids[:, lvl], mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
        at += h * w
    w = weights.permute(0, 2, 1, 3).reshape(b * hd, 1, q, lv * pt)
    out = (torch.stack(sampled, -2).flatten(-2) * w).sum(-1)  # (B * heads, d, Q)
    return out.view(b, hd * d, q).permute(0, 2, 1)


def _check(value, shapes, loc, weights) -> None:
    if value.dim() != 3 or loc.dim() != 6 or loc.shape[-1] != 2 or weights.dim() != 4:
        raise ValueError(f"deform_attention: value (B, N, C), loc (B, Q, heads, levels, points, "
                         f"2) and weights (B, Q, heads, levels * points), got "
                         f"{tuple(value.shape)}, {tuple(loc.shape)}, {tuple(weights.shape)}")
    b, q, hd, lv, pt, _ = loc.shape
    if (value.shape[0] != b or value.shape[2] % hd or tuple(weights.shape) != (b, q, hd, lv * pt)
            or len(shapes) != lv or sum(h * w for h, w in shapes) != value.shape[1]):
        raise ValueError(f"deform_attention: shapes disagree: value {tuple(value.shape)}, loc "
                         f"{tuple(loc.shape)}, weights {tuple(weights.shape)}, levels "
                         f"{list(shapes)}")
    if not value.is_cuda:
        return
    if value.dtype != torch.bfloat16 or loc.dtype != torch.float32 \
            or weights.dtype != torch.float32:
        raise ValueError(f"deform_attention: the kernel takes bf16 values and float32 locations "
                         f"and weights, got {value.dtype}, {loc.dtype}, {weights.dtype}")
    if not (value.is_contiguous() and loc.is_contiguous() and weights.is_contiguous()):
        raise ValueError("deform_attention: value, loc and weights must be contiguous")
    if loc.device != value.device or weights.device != value.device:
        raise ValueError("deform_attention: value, loc and weights must share a device")
    if lv > MAX_LEVELS:
        raise ValueError(f"deform_attention: at most {MAX_LEVELS} levels, got {lv}")


def deform_attention(value: torch.Tensor, shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """The weighted bilinear samples of each query and head.

    Args:
        value: (B, N, heads * D), the levels' tokens in order, each level
            row-major; bf16 on CUDA, contiguous.
        shapes: each level's (h, w).
        loc: (B, Q, heads, levels, points, 2) float32 (x, y) in [0, 1].
        weights: (B, Q, heads, levels * points) float32.

    Returns:
        (B, Q, heads * D): float32 on the CPU, bf16 on CUDA.
    """
    global launches
    _check(value, shapes, loc, weights)
    if value.device.type == "cpu":
        return deform_attention_reference(value, shapes, loc, weights)
    if not value.is_cuda:
        raise ValueError(f"deform_attention: unsupported device {value.device}")
    b, n, c = value.shape
    _, q, hd, lv, pt, _ = loc.shape
    out = torch.empty((b, q, c), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    levels = (ctypes.c_int * (2 * lv))(*[int(s) for hw in shapes for s in hw])
    rc = load_library().deform_attention_launch(
        value.data_ptr(), loc.data_ptr(), weights.data_ptr(), out.data_ptr(), levels, lv, b, n,
        q, hd, c // hd, pt, stream_handle(value.device))
    check(rc, "deform_attention_launch")
    launches += 1
    return out
