"""Fused int8 residual blocks (kernel K4, ``csrc/resblock_int8.cu``), its
plain torch version, operand packing, and the router ``apply_inference_int8``
calls.

Counterpart of ``yolo_for_turbines_tpu/ops/pallas/resblock_int8_kernel.py``.
A quantized Darknet-53 residual block is, in the Pallas kernel's formula,

    mid = clip(rint(act(x @ W1 * d1 + b1) * vm1))
    y   = act(conv3x3(mid) * d2 + b2)
    out = clip(rint(y * vout + x * rres), -127, 127)

with s8 x, W1, W2, mid and out, i32 accumulation and f32 per-channel
epilogue rows (``pack_int8_stage`` folds them from the calibrated scales).

Layouts follow the JAX package: x is NHWC s8, w1q is (n, C, C/2), w2q is
(n, 9, C/2, C) (taps row-major), the rows are (n, C/2) and (n, C) f32.
``fused_residual_stage_int8`` dispatches on the tensor's device: a CPU tensor
takes ``fused_residual_stage_int8_reference``; a CUDA tensor launches the
kernel once per block or raises.

Also here: ``int_mm``, the exact s8 x s8 -> i32 matrix product
(``torch._int_mm``) that the plain version and the model's unfused int8
layers share.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import check, load_library, stream_handle
from .resblock_kernel import _ACT_CODES, _ACTIVATIONS, MAX_SMEM

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) s8 @ (K, N) s8 -> (M, N) i32, exact.

    On CUDA ``torch._int_mm`` wants M > 16 and K, N multiples of 8; operands
    that miss those are zero-padded (the stem's 3*3*3 = 27) and the result
    is sliced back."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    pm, pk, pn = max(0, 17 - m), -k % 8, -n % 8
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    y = torch._int_mm(a.contiguous(), b.contiguous())
    return y[:m, :n] if (pm or pn) else y


def _requant(y: torch.Tensor) -> torch.Tensor:
    return torch.round(y).clamp_(-127, 127).to(torch.int8)


def fused_residual_stage_int8_reference(xq, w1q, d1, b1, vm1, w2q, d2, b2, vout,
                                        rres, *, activation: str = "leaky_relu"):
    """Plain torch version, in the Pallas kernel's operation order: the 1x1
    as one ``int_mm``, the 3x3 as nine shifted ``int_mm`` over the
    zero-padded s8 mid, each epilogue as separate f32 ops (no FMA)."""
    act = _ACTIVATIONS[activation]
    b, h, w, c = xq.shape
    ch = c // 2
    x = xq
    for i in range(w1q.shape[0]):
        m32 = int_mm(x.reshape(-1, c), w1q[i])
        mid = _requant(act(m32.float() * d1[i] + b1[i]) * vm1[i])
        mid = F.pad(mid.view(b, h, w, ch), (0, 0, 1, 1, 1, 1))
        acc = None
        for t in range(9):
            u, v = divmod(t, 3)
            tap = mid[:, u : u + h, v : v + w, :].reshape(-1, ch)
            p = int_mm(tap, w2q[i, t])
            acc = p if acc is None else acc + p
        y = act(acc.float() * d2[i] + b2[i])
        x = _requant(y * vout[i] + x.reshape(-1, c).float() * rres[i]).view(b, h, w, c)
    return x


def _check_cuda_args(xq, ops, activation):
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_residual_stage_int8: unsupported activation {activation!r}")
    if xq.dim() != 4:
        raise ValueError(f"fused_residual_stage_int8: x must be NHWC, got {tuple(xq.shape)}")
    b, h, w, c = xq.shape
    n, ch = ops[0].shape[0], c // 2
    names = ("w1q", "d1", "b1", "vm1", "w2q", "d2", "b2", "vout", "rres")
    shapes = ((n, c, ch), (n, ch), (n, ch), (n, ch), (n, 9, ch, c),
              (n, c), (n, c), (n, c), (n, c))
    for name, t, shape in zip(("x",) + names, (xq,) + tuple(ops), ((b, h, w, c),) + shapes):
        dtype = torch.int8 if name in ("x", "w1q", "w2q") else torch.float32
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"fused_residual_stage_int8: {name} must be {dtype} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != xq.device:
            raise ValueError(f"fused_residual_stage_int8: {name} is on {t.device}, x on {xq.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"fused_residual_stage_int8: {name} must be contiguous and 16-byte aligned")
    if c % 64:
        raise ValueError(f"fused_residual_stage_int8: C={c} must be a multiple of 64")


def fused_residual_stage_int8(xq, w1q, d1, b1, vm1, w2q, d2, b2, vout, rres, *,
                              activation: str = "leaky_relu"):
    """Run a stack of quantized residual blocks.

    Args:
        xq: (B, H, W, C) int8 activation.
        w1q: (n, C, C/2) int8 1x1 weights.
        d1/b1/vm1: (n, C/2) f32 epilogue rows (dequant, bias, 1/s_mid).
        w2q: (n, 9, C/2, C) int8 3x3 tap weights (row-major taps).
        d2/b2/vout/rres: (n, C) f32 epilogue rows.

    Returns (B, H, W, C) int8 in a new tensor; ``xq`` is left unchanged.
    """
    global launches
    ops = (w1q, d1, b1, vm1, w2q, d2, b2, vout, rres)
    if xq.device.type == "cpu":
        return fused_residual_stage_int8_reference(xq, *ops, activation=activation)
    if xq.device.type != "cuda":
        raise ValueError(f"fused_residual_stage_int8: unsupported device {xq.device}")
    _check_cuda_args(xq, ops, activation)
    b, h, w, c = xq.shape
    n = w1q.shape[0]
    lib = load_library()
    smem = lib.resblock_int8_smem_bytes(w, c)
    if smem > MAX_SMEM:
        raise ValueError(
            f"fused_residual_stage_int8: W={w}, C={c} needs {smem} B of shared "
            "memory per CTA, over the 227 KB limit"
        )
    if b == 0 or n == 0:
        return xq.clone()
    stream = stream_handle(xq.device)
    # As in the bf16 wrapper: zeroed padding around the batch for the halo
    # rows the kernel reads and discards, and two buffers the blocks
    # ping-pong between (neighbouring CTAs read each other's input rows).
    pad = lib.resblock_int8_pad_pixels(w, c) * c
    size = b * h * w * c
    bufs = []
    for _ in range(2):
        buf = torch.empty(size + 2 * pad, dtype=torch.int8, device=xq.device)
        buf[:pad].zero_()
        buf[pad + size:].zero_()
        bufs.append(buf)
    bufs[0][pad : pad + size].copy_(xq.reshape(-1))
    for i in range(n):
        src, dst = bufs[i % 2], bufs[(i + 1) % 2]
        rc = lib.resblock_int8_launch(
            src[pad:].data_ptr(), w1q[i].data_ptr(), d1[i].data_ptr(),
            b1[i].data_ptr(), vm1[i].data_ptr(), w2q[i].data_ptr(),
            d2[i].data_ptr(), b2[i].data_ptr(), vout[i].data_ptr(),
            rres[i].data_ptr(), dst[pad:].data_ptr(),
            b, h, w, c, _ACT_CODES[activation], stream,
        )
        check(rc, "resblock_int8_launch")
        launches += 1
    return bufs[n % 2][pad : pad + size].view(b, h, w, c)


def pack_int8_stage(blocks_q: Sequence[dict], s_in, s1_list, s2_list):
    """Per-block quantized dicts (``models/quantize.py::_q_blocks`` layout:
    w1q/s1/b1/w2q/s2/b2, HWIO int8 weights) + the calibrated scale chain ->
    the stacked kernel operands ``(w1q, d1, b1, vm1, w2q, d2, b2, vout,
    rres)``. ``s_in`` is the stage input scale, ``s1_list``/``s2_list`` each
    block's mid/out scales, all f32 0-dim tensors; the f32 arithmetic is the
    JAX function's."""
    w1q = torch.stack([bq["w1q"].reshape(bq["w1q"].shape[-2], -1) for bq in blocks_q])
    w2q = torch.stack([bq["w2q"].reshape(9, *bq["w2q"].shape[-2:]) for bq in blocks_q])
    d1, b1, vm1, d2, b2, vout, rres = [], [], [], [], [], [], []
    s = s_in
    for bq, s_mid, s_out in zip(blocks_q, s1_list, s2_list):
        d1.append(bq["s1"] * s)
        b1.append(bq["b1"])
        vm1.append(torch.reciprocal(s_mid).expand(bq["s1"].shape))
        d2.append(bq["s2"] * s_mid)
        b2.append(bq["b2"])
        vout.append(torch.reciprocal(s_out).expand(bq["s2"].shape))
        rres.append((s / s_out).expand(bq["s2"].shape))
        s = s_out
    return (
        w1q.contiguous(), torch.stack(d1), torch.stack(b1), torch.stack(vm1),
        w2q.contiguous(), torch.stack(d2), torch.stack(b2), torch.stack(vout),
        torch.stack(rres),
    )


def int8_stage_wins(h: int, w: int, c: int) -> bool:
    """Geometry class the fused int8 stage is routed to: c >= 512 and
    16^2 <= h*w <= 32^2 (the 26x26x512 stage of Darknet-53 at 416px), at
    every batch size. The JAX router's batch gate and measured-winner table
    were TPU measurements and are not applied."""
    return c >= 512 and 16 * 16 <= h * w <= 32 * 32


def apply_residual_stage_int8_fused(ops, xq, activation: str) -> Optional[torch.Tensor]:
    """Router for a quantized use_residual stage: ``ops`` from
    ``pack_int8_stage``, xq NHWC s8; returns None when the geometry stays on
    the layer-by-layer int8 path."""
    _, h, w, c = xq.shape
    if not int8_stage_wins(h, w, c):
        return None
    return fused_residual_stage_int8(xq, *ops, activation=activation)
