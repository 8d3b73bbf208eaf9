"""A folded conv's bias, activation and residual add in one pass (kernel K5,
``csrc/epilogue.cu``), and its plain torch version.

K5 replaces no TPU kernel: XLA fused these ops into its convolution. On the
card cuDNN computes the convolution (``F.conv2d`` without its bias) and K5
then rewrites the output ``y`` in place:

    y = bf16(skip + act(float(y) + float(bias)))    # skip optional
    y = bf16(act(float(y) + float(bias) + float(skip)))    # add_first

with ``act`` identity, leaky_relu(0.1), mish, silu or relu, in f32 and
rounded once; the second order (``add_first``) is a ResNet bottleneck's,
whose shortcut joins before its ReLU,
where the composition it replaces (the conv's bias add, the activation,
``x + y``) read and wrote the activation three times and rounded it each
time. ``y`` and ``skip`` are (B, C, H, W) tensors stored channels_last (NHWC
memory), as the folded model keeps its activations; ``bias`` is (C,).

The result may go into ``out`` instead, a channel slice of a channels_last
concat buffer (``models/blocks.py::ChannelConcat``), so that the concat
needs no copy pass; with ``keep`` into ``y`` as well, for a part that a
later conv reads too. The values are the same bits either way.

``conv_epilogue`` dispatches on the tensor's device: a CPU tensor takes
``conv_epilogue_reference``; a CUDA tensor launches the kernel (bf16 only)
or raises. ``models/blocks.py::FoldedConv`` sends it what it takes and keeps
the composition for every other input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import check, load_library, stream_handle

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

# the activation codes of csrc/epilogue.cu
ACT_CODES = {"identity": 0, "leaky_relu": 1, "mish": 2, "silu": 3, "relu": 4}
# or'd into the code: the skip joins before the activation (identity and
# relu take it)
ADD_FIRST = 16
_ACTIVATIONS = {
    "identity": lambda t: t,
    "leaky_relu": lambda t: F.leaky_relu(t, 0.1),
    "mish": F.mish,
    "silu": F.silu,
    # a NaN and a -0 pass as they are, as the kernel's
    "relu": lambda t: torch.where(t < 0, torch.zeros_like(t), t),
}


def conv_epilogue_reference(y: torch.Tensor, bias: torch.Tensor, activation: str = "identity",
                            skip: Optional[torch.Tensor] = None,
                            add_first: bool = False) -> torch.Tensor:
    """Plain torch version: ``skip + act(y + bias)``, or with ``add_first``
    ``act(y + bias + skip)``, in f32, rounded once to ``y.dtype``; a new
    tensor."""
    t = y.float() + bias.float()[:, None, None]
    if add_first and skip is not None:
        return _ACTIVATIONS[activation](t + skip.float()).to(y.dtype)
    t = _ACTIVATIONS[activation](t)
    if skip is not None:
        t = t + skip.float()
    return t.to(y.dtype)


def _check(y, bias, activation, skip, add_first=False) -> None:
    if activation not in ACT_CODES:
        raise ValueError(f"conv_epilogue: unsupported activation {activation!r}")
    if add_first and activation not in ("identity", "relu"):
        raise ValueError(f"conv_epilogue: the add-first order takes identity or relu, got "
                         f"{activation!r}")
    if y.dim() != 4 or not y.is_floating_point():
        raise ValueError(f"conv_epilogue: y must be a float (B, C, H, W) tensor, got "
                         f"{y.dtype} {tuple(y.shape)}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_epilogue: y must be stored channels_last (NHWC memory)")
    if bias.shape != (y.shape[1],) or bias.dtype != y.dtype or bias.device != y.device:
        raise ValueError(f"conv_epilogue: bias must be {y.dtype} ({y.shape[1]},) on {y.device}, "
                         f"got {bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if not bias.is_contiguous():
        raise ValueError("conv_epilogue: bias must be contiguous")
    if skip is None:
        return
    if skip.shape != y.shape or skip.dtype != y.dtype or skip.device != y.device:
        raise ValueError(f"conv_epilogue: skip must be {y.dtype} {tuple(y.shape)} on {y.device}, "
                         f"got {skip.dtype} {tuple(skip.shape)} on {skip.device}")
    if not skip.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_epilogue: skip must be stored channels_last (NHWC memory)")
    if _overlap(skip, y):
        raise ValueError("conv_epilogue: skip overlaps y, which is written in place")


def _extent(t: torch.Tensor):
    """The bytes ``[first, last)`` that ``t``'s elements span."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.numel() == 0 or b.numel() == 0:
        return False
    (a0, a1), (b0, b1) = _extent(a), _extent(b)
    return a0 < b1 and b0 < a1


def _slice_pitch(out: torch.Tensor) -> Optional[int]:
    """The channels of the channels_last (B, P, H, W) buffer that (B, C, H,
    W) ``out`` is a channel slice of (``buffer[:, a:a + C]``: strides (H W P,
    1, W P, P), P >= C), or None when ``out`` is not one."""
    b, c, h, w = out.shape
    pitch = out.stride(3)
    return pitch if pitch >= c and out.stride() == (h * w * pitch, 1, w * pitch, pitch) else None


def _check_out(y, skip, out) -> int:
    if out.shape != y.shape or out.dtype != y.dtype or out.device != y.device:
        raise ValueError(f"conv_epilogue: out must be {y.dtype} {tuple(y.shape)} on {y.device}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    pitch = _slice_pitch(out)
    if pitch is None:
        raise ValueError("conv_epilogue: out must be a channel slice of a channels_last buffer")
    if _overlap(out, y) or (skip is not None and _overlap(out, skip)):
        raise ValueError("conv_epilogue: out overlaps y or skip")
    return pitch


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, activation: str = "identity",
                  skip: Optional[torch.Tensor] = None, add_first: bool = False,
                  out: Optional[torch.Tensor] = None, keep: bool = False) -> torch.Tensor:
    """Write ``skip + act(y + bias)`` (with ``add_first``: ``act(y + bias +
    skip)``) into ``y`` and return ``y``; or into ``out`` and return
    ``out``, with ``keep`` into ``y`` as well (then ``y`` is returned).

    Args:
        y: (B, C, H, W) conv output stored channels_last; bf16 on CUDA.
        bias: (C,) in ``y``'s dtype.
        activation: "identity", "leaky_relu" (slope 0.1), "mish", "silu" or
            "relu".
        skip: None, or a tensor like ``y`` (a residual block's input) that
            does not overlap it.
        add_first: the skip joins before the activation (identity or relu).
        out: None, or a channel slice of a channels_last (B, C', H, W)
            buffer with ``y``'s shape and dtype (``buffer[:, a:a + C]``),
            overlapping neither ``y`` nor ``skip``.
        keep: with ``out``, write ``y`` too.
    """
    global launches
    _check(y, bias, activation, skip, add_first)
    pitch = None if out is None else _check_out(y, skip, out)
    if not y.is_cuda and y.device.type == "cpu":
        result = conv_epilogue_reference(y, bias, activation, skip, add_first)
        if out is None:
            return y.copy_(result)
        out.copy_(result)
        return y.copy_(result) if keep else out
    if y.dtype != torch.bfloat16:
        raise ValueError(f"conv_epilogue: the kernel takes bf16, got {y.dtype}")
    if not y.is_cuda:
        raise ValueError(f"conv_epilogue: unsupported device {y.device}")
    if y.numel() == 0:
        return y if out is None or keep else out
    b, c, h, w = y.shape
    act = ACT_CODES[activation] | (ADD_FIRST if add_first else 0)
    skip_ptr = None if skip is None else skip.data_ptr()
    if out is None:
        rc = load_library().conv_epilogue_launch(y.data_ptr(), bias.data_ptr(), skip_ptr,
                                                 b * h * w, c, act, stream_handle(y.device))
        check(rc, "conv_epilogue_launch")
    else:
        rc = load_library().conv_epilogue_slice_launch(
            y.data_ptr(), bias.data_ptr(), skip_ptr, out.data_ptr(), b * h * w, c, pitch,
            int(keep), act, stream_handle(y.device))
        check(rc, "conv_epilogue_slice_launch")
    launches += 1
    return y if out is None or keep else out
