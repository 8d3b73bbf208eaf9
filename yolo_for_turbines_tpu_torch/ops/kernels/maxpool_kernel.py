"""The max pools of the folded bf16 forward (kernel K8, ``csrc/maxpool.cu``),
and their plain torch versions.

K8 replaces no TPU kernel: the JAX package pools with ``lax.reduce_window``
and XLA fused the pools with the concat after them. It has two geometries:

- ``maxpool_pyramid(x, windows)``: the stride-1 SAME pools of ``windows``
  (odd; 1 is ``x`` itself) written side by side into one ``(B, len(windows)
  * C, H, W)`` result, slot ``s`` the max of ``x`` over ``windows[s]`` with
  the cells outside the plane skipped, as ``F.max_pool2d(x, k, 1,
  padding=k // 2)``: YOLOv4's SPP and YOLOv7's SPPCSPC, pools and concat in
  one pass that reads the plane once;
- ``maxpool2x2(x, stride)``: 2x2 windows, at stride 2 VALID as
  ``F.max_pool2d(x, 2, 2)`` (YOLOv7's MP, tiny's down-sampling pools), at
  stride 1 SAME with the pad after, as the JAX ``maxpool2d`` (tiny's last
  pool);
- ``maxpool3x3s2(x)``: 3x3 windows at stride 2 with a symmetric pad of 1
  (-inf), as ``F.max_pool2d(x, 3, 2, 1)``: the ResNet stem's pool
  (RT-DETR's ResNet-50-vd).

``x`` is a (B, C, H, W) tensor stored channels_last (NHWC memory), as the
folded model keeps its activations, and so is the result. Max is
order-free, so K8 gives the aten composition's values: a NaN anywhere in a
window gives NaN, -inf stays, and of +0 and -0 in one window either may come
out.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the plain
version (the aten composition); a CUDA tensor launches the kernel or raises.
``apply_pyramid``, ``apply_maxpool2x2`` and ``apply_maxpool3x3s2`` launch
it for any bf16 CUDA tensor: they copy one that is not channels_last,
16-byte aligned and 8 channels wide into a fresh one first (zero channels
up to a multiple of 8, cut from the result) and give the result the input's
layout. ``models/blocks.py`` (``pool_wins``, ``maxpool_pyramid``,
``maxpool2d``, ``maxpool3x3s2``) sends them every bf16 CUDA tensor that
needs no grad.
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

MAX_SLOTS = 8
# the most dynamic shared memory a pyramid CTA takes: a plane whose two
# copies at 8 channels exceed it goes in bands of rows with halos as wide as
# the largest window's radius
SMEM_MAX = 227 * 1024
CL = torch.channels_last


def pyramid_parts(x: torch.Tensor, windows: Sequence[int]) -> list:
    """Each window's padded ``F.max_pool2d`` (``x`` for 1), in order."""
    return [x if k == 1 else F.max_pool2d(x, k, 1, padding=k // 2) for k in windows]


def maxpool_pyramid_reference(x: torch.Tensor, windows: Sequence[int]) -> torch.Tensor:
    """Plain torch version: ``pyramid_parts`` concatenated along channels."""
    return torch.cat(pyramid_parts(x, windows), dim=1)


def maxpool2x2_reference(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Plain torch version: ``F.max_pool2d(x, 2, 2)``, or at stride 1 the
    pool over x padded with -inf after its last row and column."""
    if stride == 1:
        x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
    return F.max_pool2d(x, 2, stride)


def maxpool3x3s2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``F.max_pool2d(x, 3, 2, 1)``."""
    return F.max_pool2d(x, 3, 2, 1)


def _check(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4 or not x.is_floating_point():
        raise ValueError(f"{what}: x must be a float (B, C, H, W) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bf16, got {x.dtype}")
    if not x.is_contiguous(memory_format=CL):
        raise ValueError(f"{what}: x must be stored channels_last (NHWC memory)")
    if x.shape[1] % 8 != 0 or x.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: the kernel takes C % 8 == 0 and 16-byte aligned storage, got "
                         f"C = {x.shape[1]} at address {x.data_ptr():#x}")


def _windows(windows: Sequence[int]) -> Tuple[int, ...]:
    windows = tuple(int(k) for k in windows)
    if not 1 <= len(windows) <= MAX_SLOTS or any(k < 1 or k % 2 == 0 for k in windows):
        raise ValueError(f"maxpool_pyramid: 1 to {MAX_SLOTS} odd windows, got {windows}")
    return windows


def _pyramid_fits(h: int, w: int, windows: Tuple[int, ...]) -> bool:
    """Whether the pyramid takes an H x W plane: the whole plane or a band
    of one row and its halos in ``SMEM_MAX`` (``csrc/maxpool.cu``)."""
    row_bytes = 2 * 16 * w
    return min(h, 1 + 2 * ((max(windows) - 1) // 2)) * row_bytes <= SMEM_MAX


def maxpool_pyramid(x: torch.Tensor, windows: Sequence[int]) -> torch.Tensor:
    """The stride-1 SAME max pools of ``windows`` side by side along
    channels.

    Args:
        x: (B, C, H, W) stored channels_last; bf16 on CUDA, C % 8 == 0, the
            storage 16-byte aligned, rows of at most 558 pixels for windows
            up to 13.
        windows: 1 to 8 odd window sizes; 1 is ``x`` itself.

    Returns:
        (B, len(windows) * C, H, W) stored channels_last.
    """
    global launches
    windows = _windows(windows)
    _check(x, "maxpool_pyramid")
    if x.device.type == "cpu":
        return maxpool_pyramid_reference(x, windows)
    if not x.is_cuda:
        raise ValueError(f"maxpool_pyramid: unsupported device {x.device}")
    b, c, h, w = x.shape
    if not _pyramid_fits(h, w, windows):
        raise ValueError(f"maxpool_pyramid: rows of {w} pixels with windows {windows} exceed "
                         f"the kernel's {SMEM_MAX} bytes of shared memory")
    out = torch.empty((b, len(windows) * c, h, w), dtype=x.dtype, device=x.device,
                      memory_format=CL)
    if out.numel() == 0:
        return out
    arr = (ctypes.c_int * len(windows))(*windows)
    rc = load_library().maxpool_pyramid_launch(
        x.data_ptr(), out.data_ptr(), arr, len(windows), b, h, w, c, stream_handle(x.device))
    check(rc, "maxpool_pyramid_launch")
    launches += 1
    return out


def maxpool2x2(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """2x2 max pool: stride 2 VALID (floor sizes) or stride 1 SAME (the pad
    after the last row and column).

    Args:
        x: (B, C, H, W) stored channels_last; bf16 on CUDA, C % 8 == 0, the
            storage 16-byte aligned.
        stride: 2 or 1.

    Returns:
        (B, C, H // 2, W // 2) at stride 2, (B, C, H, W) at stride 1, stored
        channels_last.
    """
    global launches
    if stride not in (1, 2):
        raise ValueError(f"maxpool2x2: stride 1 or 2, got {stride}")
    _check(x, "maxpool2x2")
    if x.device.type == "cpu":
        return maxpool2x2_reference(x, stride)
    if not x.is_cuda:
        raise ValueError(f"maxpool2x2: unsupported device {x.device}")
    b, c, h, w = x.shape
    ho, wo = (h // 2, w // 2) if stride == 2 else (h, w)
    if ho * wo * (c // 8) > 2**30:
        raise ValueError(f"maxpool2x2: {h}x{w}x{c} exceeds the kernel's 32-bit index")
    out = torch.empty((b, c, ho, wo), dtype=x.dtype, device=x.device, memory_format=CL)
    if out.numel() == 0:
        return out
    rc = load_library().maxpool2x2_launch(x.data_ptr(), out.data_ptr(), b, h, w, c, stride,
                                          stream_handle(x.device))
    check(rc, "maxpool2x2_launch")
    launches += 1
    return out


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool at stride 2 with a symmetric pad of 1 (-inf).

    Args:
        x: (B, C, H, W) stored channels_last; bf16 on CUDA, C % 8 == 0, the
            storage 16-byte aligned.

    Returns:
        (B, C, (H - 1) // 2 + 1, (W - 1) // 2 + 1) stored channels_last.
    """
    global launches
    _check(x, "maxpool3x3s2")
    if x.device.type == "cpu":
        return maxpool3x3s2_reference(x)
    if not x.is_cuda:
        raise ValueError(f"maxpool3x3s2: unsupported device {x.device}")
    b, c, h, w = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    if ho * wo * (c // 8) > 2**30:
        raise ValueError(f"maxpool3x3s2: {h}x{w}x{c} exceeds the kernel's 32-bit index")
    out = torch.empty((b, c, ho, wo), dtype=x.dtype, device=x.device, memory_format=CL)
    if out.numel() == 0:
        return out
    rc = load_library().maxpool3x3s2_launch(x.data_ptr(), out.data_ptr(), b, h, w, c,
                                            stream_handle(x.device))
    check(rc, "maxpool3x3s2_launch")
    launches += 1
    return out


def _operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as K8 reads it: itself if it is stored channels_last, 16-byte
    aligned and a multiple of 8 channels wide; else a fresh channels_last
    copy with zero channels up to that multiple."""
    b, c, h, w = x.shape
    wide = -(-c // 8) * 8
    if wide == c and x.is_contiguous(memory_format=CL) and x.data_ptr() % 16 == 0:
        return x
    fresh = torch.empty((b, wide, h, w), dtype=x.dtype, device=x.device, memory_format=CL)
    fresh[:, :c] = x
    fresh[:, c:].zero_()
    return fresh


def _as_input(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out`` (channels_last) in ``x``'s layout: NCHW memory where ``x`` is
    stored so, as aten's pools give."""
    if x.is_contiguous() and not x.is_contiguous(memory_format=CL):
        return out.contiguous()
    return out


def apply_pyramid(x: torch.Tensor, windows: Sequence[int]) -> torch.Tensor:
    """``maxpool_pyramid`` in any layout, alignment and width: through
    ``_operand``, the padded channels cut from each slot."""
    windows = _windows(windows)
    c = x.shape[1]
    xk = _operand(x)
    out = maxpool_pyramid(xk, windows)
    if xk.shape[1] != c:
        cut = torch.empty((out.shape[0], len(windows) * c) + out.shape[2:], dtype=out.dtype,
                          device=out.device, memory_format=CL)
        cut.unflatten(1, (len(windows), c)).copy_(
            out.unflatten(1, (len(windows), xk.shape[1]))[:, :, :c])
        out = cut
    return _as_input(out, x)


def apply_maxpool2x2(x: torch.Tensor, stride: int) -> torch.Tensor:
    """``maxpool2x2`` in any layout, alignment and width: through
    ``_operand``, the padded channels cut."""
    c = x.shape[1]
    out = maxpool2x2(_operand(x), stride)
    if out.shape[1] != c:
        out = out[:, :c].contiguous(memory_format=CL)
    return _as_input(out, x)


def apply_maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """``maxpool3x3s2`` in any layout, alignment and width: through
    ``_operand``, the padded channels cut."""
    c = x.shape[1]
    out = maxpool3x3s2(_operand(x))
    if out.shape[1] != c:
        out = out[:, :c].contiguous(memory_format=CL)
    return _as_input(out, x)
