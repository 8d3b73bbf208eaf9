"""An int8 conv's epilogue in one pass (kernel K6, ``csrc/epilogue.cu``), and
its plain torch version.

K6 replaces no TPU kernel: XLA fused the int8 conv's epilogue into its int32
convolution. On the card ``torch._int_mm`` writes the conv's i32 output and
K6 turns it into the next layer's s8 codes:

    q = s8(clamp(rint((act(f32(y32) * d [+ f32(y32b) * db] + b)
                       [+ f32(rq) * rs]) / s_out), -127, 127))

per element of the NHWC output, with ``d``, ``db`` and ``b`` per output
channel, ``act`` leaky_relu(0.1) or mish, ``extra = (y32b, db)`` the second
branch of a conv that reads a concat as two int8 convs and ``residual =
(rq, rs)`` a residual block's input codes and scale. The plain version is
the composition of aten ops that ``models/quantize.py`` ran after every
int8 conv, in place on one f32 buffer and in the JAX package's operation
order; K6 does the same f32 operations in the same order, each rounded once,
in one pass, and gives the same codes bit for bit.

``int8_epilogue`` dispatches on the tensor's device: a CPU tensor takes
``int8_epilogue_reference``; a CUDA tensor launches the kernel or raises.
``models/quantize.py::_epilogue`` sends it every int8 conv's output that is
not on the portable path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import check, load_library, stream_handle

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

# the activation codes of csrc/epilogue.cu
ACT_CODES = {"leaky_relu": 1, "mish": 2}
# in-place twins of the activations (the same kernels, one buffer fewer)
_ACT_INPLACE = {
    "leaky_relu": lambda t: F.leaky_relu_(t, 0.1),
    "mish": lambda t: F.mish(t, inplace=True),
}

Pair = Tuple[torch.Tensor, torch.Tensor]


def int8_epilogue_reference(y32: torch.Tensor, d: torch.Tensor, b: torch.Tensor,
                            s_out: torch.Tensor, activation: str,
                            residual: Optional[Pair] = None,
                            extra: Optional[Pair] = None) -> torch.Tensor:
    """Plain torch version: dequant + bias + activation (+ residual add) +
    requant, in f32 in the JAX operation order, in place on one f32 buffer;
    new s8 codes."""
    y = y32.float().mul_(d)
    if extra is not None:
        y.add_(extra[0].float().mul_(extra[1]))
    y = _ACT_INPLACE[activation](y.add_(b))
    if residual is not None:
        rq, rs = residual
        y.add_(rq.float().mul_(rs))
    return y.div_(s_out).round_().clamp_(-127, 127).to(torch.int8)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _byte_range(t: torch.Tensor) -> Tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check(y32, d, b, s_out, activation, residual, extra, out) -> None:
    if activation not in ACT_CODES:
        raise ValueError(f"int8_epilogue: unsupported activation {activation!r}")
    if y32.dim() != 4 or y32.dtype != torch.int32 or not y32.is_contiguous():
        raise ValueError(f"int8_epilogue: y32 must be a contiguous int32 (B, H, W, C) tensor, "
                         f"got {y32.dtype} {tuple(y32.shape)}")
    c, dev = y32.shape[-1], y32.device

    def per_channel(name, t):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"int8_epilogue: {name} must be float32 ({c},) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_epilogue: {name} must be contiguous")

    def scalar(name, t):
        if t.dim() != 0 or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"int8_epilogue: {name} must be a float32 0-dim tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")

    def like_y(name, t, dtype):
        if t.shape != y32.shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"int8_epilogue: {name} must be {dtype} {tuple(y32.shape)} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_epilogue: {name} must be contiguous")

    per_channel("d", d)
    per_channel("b", b)
    scalar("s_out", s_out)
    inputs = [y32]
    if residual is not None:
        like_y("the residual codes", residual[0], torch.int8)
        scalar("the residual scale", residual[1])
        inputs.append(residual[0])
    if extra is not None:
        like_y("the second branch", extra[0], torch.int32)
        per_channel("the second branch's scales", extra[1])
        inputs.append(extra[0])
    if out is None:
        return
    like_y("out", out, torch.int8)
    lo, hi = _byte_range(out)
    for t in inputs:
        a, z = _byte_range(t)
        if a < hi and lo < z:
            raise ValueError("int8_epilogue: out overlaps an input")


def int8_epilogue(y32: torch.Tensor, d: torch.Tensor, b: torch.Tensor, s_out: torch.Tensor,
                  activation: str, residual: Optional[Pair] = None,
                  extra: Optional[Pair] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An int8 conv's epilogue: the s8 codes of ``y32``'s next layer.

    Args:
        y32: (B, H, W, C) int32 conv output, contiguous (NHWC).
        d, b: (C,) float32 dequant scales and bias.
        s_out: float32 0-dim output scale, on ``y32``'s device.
        activation: "leaky_relu" (slope 0.1) or "mish".
        residual: None, or (codes like ``y32`` in int8, 0-dim float32
            scale): a residual block's input, added after the activation.
        extra: None, or (int32 like ``y32``, (C,) float32 scales): the
            second branch of a conv split at a concat, added before the
            bias.
        out: None, or an int8 tensor like ``y32`` that overlaps no input,
            written and returned.
    """
    global launches
    _check(y32, d, b, s_out, activation, residual, extra, out)
    if y32.device.type == "cpu":
        codes = int8_epilogue_reference(y32, d, b, s_out, activation, residual, extra)
        return codes if out is None else out.copy_(codes)
    if not y32.is_cuda:
        raise ValueError(f"int8_epilogue: unsupported device {y32.device}")
    if out is None:
        out = torch.empty(y32.shape, dtype=torch.int8, device=y32.device)
    if y32.numel() == 0:
        return out
    rq, rs = residual if residual is not None else (None, None)
    y32b, db = extra if extra is not None else (None, None)
    c = y32.shape[-1]
    rc = load_library().int8_epilogue_launch(
        y32.data_ptr(), _ptr(y32b), _ptr(rq), out.data_ptr(), d.data_ptr(), _ptr(db),
        b.data_ptr(), s_out.data_ptr(), _ptr(rs), y32.numel() // c, c, ACT_CODES[activation],
        stream_handle(y32.device))
    check(rc, "int8_epilogue_launch")
    launches += 1
    return out
