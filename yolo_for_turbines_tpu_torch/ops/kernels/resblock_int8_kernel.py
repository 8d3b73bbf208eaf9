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
kernel once per block or raises. The kernel (s8 wgmma + TMA, ``sm_90a``) runs
one block per launch over tiles of 128 positions x 256 output channels and
takes C = 512 and W <= 32 (``kernel_takes``); it reads the weights K-major
(``kmajor_weights``), which ``models/quantize.py::pack_int8`` makes once per
model for every stage whose channel count the kernel takes.

Also here: ``int_mm``, the exact s8 x s8 -> i32 matrix product
(``torch._int_mm``) that the plain version and the model's unfused int8
layers share.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import check, load_library, stream_handle
from .resblock_kernel import (
    _ACT_CODES,
    _ACTIVATIONS,
    KERNEL_C,
    KERNEL_MAX_W,
    geometry_wins,
    kernel_takes,
    kmajor_weights,
)

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) s8 @ (K, N) s8 -> (M, N) i32, exact.

    On CUDA ``torch._int_mm`` wants M > 16 and K, N multiples of 8; operands
    that miss those are zero-padded (the stem's 3*3*3 = 27) and the result
    is sliced back. The padding is done on every device (the products are
    exact either way), so that a program traced on the CPU
    (``serving.export_serving_module``) runs on the card too."""
    m, k = a.shape
    n = b.shape[1]
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


def smem_plan(w: int) -> dict:
    """The shared-memory plan of one CTA of ``csrc/resblock_int8.cu`` for a
    width ``w`` (its ``Layout``), in bytes from a 1024-aligned base: the 1x1
    holds the x tile (4 K chunks of 128 channels) and the CTA's half of W1;
    the 3x3 reuses that memory for ``mid`` (two 128-channel blocks) and a
    5-slot ring of 32 KB W2 tiles whose slots count down from ``ring_end``;
    then the barriers and the staged epilogue rows. ``th`` is the output rows
    of a tile, ``n1`` the positions of the 1x1, ``w2_early`` the ring slots
    that lie past the x tile and W1 and so fill while the 1x1 runs."""
    def round_up(v, m):
        return -(-v // m) * m

    k1, w1_tile, w2_stages, w2_tile, tail = 4, 128 * 128, 5, 256 * 128, 256 + (128 + 256) * 16
    th = 128 // (w + 2)
    n1 = (th + 2) * w
    xchunk = round_up(n1, 8) * 128
    w1_off = k1 * xchunk
    mid_block = round_up((128 + 2 * (w + 2) + 2) * 128, 1024)
    ring_end = 2 * mid_block + w2_stages * w2_tile
    end1 = w1_off + k1 * w1_tile
    bar_off = max(end1, ring_end)
    return {
        "th": th, "n1": n1, "xchunk": xchunk, "w1_off": w1_off, "end1": end1,
        "mid_block": mid_block, "ring_end": ring_end,
        "slot_off": [ring_end - (s + 1) * w2_tile for s in range(w2_stages)],
        "w2_early": min(w2_stages, max(0, ring_end - end1) // w2_tile),
        "res_bytes": th * w * 128, "res_stride": round_up(th * w * 128, 1024),
        "bar_off": bar_off, "smem_bytes": 1024 + bar_off + tail,
    }


def _check_cuda_args(xq, ops, activation, kmajor=None):
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_residual_stage_int8: unsupported activation {activation!r}")
    if xq.dim() != 4:
        raise ValueError(f"fused_residual_stage_int8: x must be NHWC, got {tuple(xq.shape)}")
    b, h, w, c = xq.shape
    n, ch = ops[0].shape[0], c // 2
    i8, f32 = torch.int8, torch.float32
    names = ("w1q", "d1", "b1", "vm1", "w2q", "d2", "b2", "vout", "rres")
    shapes = ((n, c, ch), (n, ch), (n, ch), (n, ch), (n, 9, ch, c),
              (n, c), (n, c), (n, c), (n, c))
    dtypes = (i8, f32, f32, f32, i8, f32, f32, f32, f32)
    expected = [("x", xq, (b, h, w, c), i8), *zip(names, ops, shapes, dtypes)]
    if kmajor is not None:
        expected += [("w1 (K-major)", kmajor[0], (n, ch, c), i8),
                     ("w2 (K-major)", kmajor[1], (n, c, 9 * ch), i8)]
    for name, t, shape, dtype in expected:
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
    if not kernel_takes(h, w, c):
        raise ValueError(
            f"fused_residual_stage_int8: the kernel takes C={KERNEL_C} and "
            f"1 <= W <= {KERNEL_MAX_W}, got H={h}, W={w}, C={c}"
        )


def fused_residual_stage_int8(xq, w1q, d1, b1, vm1, w2q, d2, b2, vout, rres, *,
                              activation: str = "leaky_relu",
                              kmajor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Run a stack of quantized residual blocks.

    Args:
        xq: (B, H, W, C) int8 activation.
        w1q: (n, C, C/2) int8 1x1 weights.
        d1/b1/vm1: (n, C/2) f32 epilogue rows (dequant, bias, 1/s_mid).
        w2q: (n, 9, C/2, C) int8 3x3 tap weights (row-major taps).
        d2/b2/vout/rres: (n, C) f32 epilogue rows.
        kmajor: ``kmajor_weights(w1q, w2q)``, which the CUDA kernel reads;
            made here when not given (a model packs them once).

    Returns (B, H, W, C) int8 in a new tensor; ``xq`` is left unchanged.
    """
    global launches
    ops = (w1q, d1, b1, vm1, w2q, d2, b2, vout, rres)
    if xq.device.type == "cpu":
        return fused_residual_stage_int8_reference(xq, *ops, activation=activation)
    if xq.device.type != "cuda":
        raise ValueError(f"fused_residual_stage_int8: unsupported device {xq.device}")
    _check_cuda_args(xq, ops, activation, kmajor)
    b, h, w, c = xq.shape
    n = w1q.shape[0]
    if b == 0 or n == 0:
        return xq.clone()
    lib = load_library()
    stream = stream_handle(xq.device)
    w1t, w2t = kmajor if kmajor is not None else kmajor_weights(w1q, w2q)
    # Neighbouring CTAs read each other's halo rows, so a block never
    # writes its input: xq, then two buffers in turn.
    bufs = [torch.empty_like(xq) for _ in range(min(n, 2))]
    # block i's operands by address: slicing nine tensors per launch would
    # cost the host more than a small batch costs the card
    operands = (w1t, d1, b1, vm1, w2t, d2, b2, vout, rres)
    bases = [t.data_ptr() for t in operands]
    steps = [t.stride(0) * t.element_size() for t in operands]
    act = _ACT_CODES[activation]
    src = xq
    for i in range(n):
        dst = bufs[i % 2]
        rc = lib.resblock_int8_launch(
            src.data_ptr(), *(base + i * step for base, step in zip(bases, steps)),
            dst.data_ptr(), b, h, w, c, act, stream,
        )
        check(rc, "resblock_int8_launch")
        launches += 1
        src = dst
    return src


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


def apply_residual_stage_int8_fused(ops, xq, activation: str,
                                    kmajor=None) -> Optional[torch.Tensor]:
    """Router for a quantized use_residual stage: ``ops`` from
    ``pack_int8_stage`` (``kmajor`` from ``kmajor_weights``), xq NHWC s8;
    returns None when the geometry of this call stays on the layer-by-layer
    int8 path. The geometry class is the bf16 router's
    (``resblock_kernel.geometry_wins``), at every batch size: the JAX
    router's batch gate and measured-winner table were TPU measurements and
    are not applied."""
    _, h, w, c = xq.shape
    if not geometry_wins(h, w, c):
        return None
    return fused_residual_stage_int8(xq, *ops, activation=activation, kmajor=kmajor)
