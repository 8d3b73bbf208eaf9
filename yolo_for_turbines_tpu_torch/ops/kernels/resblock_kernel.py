"""Fused folded residual blocks (kernel K2, ``csrc/resblock.cu``), its plain
torch version, and the routing predicate the model asks.

Counterpart of ``yolo_for_turbines_tpu/ops/pallas/resblock_kernel.py``. A
Darknet-53 residual block at inference is

    x = x + act(conv3x3(act(x @ W1 + b1)) + b2)

with f32 accumulation, ``mid`` rounded to the activation dtype, and the
residual added in the activation dtype. The Pallas kernel runs a chunk of
blocks per launch with the image resident in VMEM; the CUDA kernel (wgmma +
TMA, ``sm_90a``) runs one block per launch over tiles of 128 positions x 256
output channels (see the note at the top of the source). It takes C = 512,
W <= 32 (``kernel_takes``) and bf16; the model sends it nothing else, and a
CUDA stage of another dtype stays on the layer path (``stage_wins``). The
kernel reads the weights K-major (``kmajor_weights``), which
``models/yolov3.py::ResidualStage`` makes once, at its first routed call on
CUDA.

Layouts follow the JAX package: x is NHWC, w1s is (n, C, C/2) or
(n, 1, 1, C, C/2), w2s is (n, 3, 3, C/2, C) HWIO, biases are (n, C/2) and
(n, C). ``fused_residual_stage`` dispatches on the tensor's device: a CPU
tensor takes ``fused_residual_stage_reference``; a CUDA tensor launches the
kernel once per block or raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import check, load_library, stream_handle

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0

MAX_SMEM = 232448  # shared memory one CTA may opt into on sm_90 (227 KB)

# the geometry csrc/resblock.cu takes (its kC and kMaxW)
KERNEL_C = 512
KERNEL_MAX_W = 32

_ACT_CODES = {"leaky_relu": 0, "mish": 1}
_ACTIVATIONS = {
    "leaky_relu": lambda t: F.leaky_relu(t, 0.1),
    "mish": F.mish,
}


def fused_residual_stage_reference(x, w1s, b1s, w2s, b2s, *,
                                   activation: str = "leaky_relu"):
    """Plain torch version: the 1x1 as a matmul, the 3x3 via
    ``F.conv2d(padding=1)``, both in f32 on operands rounded to ``x.dtype``;
    rounds to ``x.dtype`` after each activation, as the kernels do."""
    act = _ACTIVATIONS[activation]
    dt = x.dtype
    n, c = w2s.shape[0], x.shape[-1]
    ch = c // 2
    w1s = w1s.reshape(n, c, ch)
    for i in range(n):
        mid = act(x.float() @ w1s[i].to(dt).float() + b1s[i].float()).to(dt)
        w2 = w2s[i].to(dt).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(mid.permute(0, 3, 1, 2).float(), w2, padding=1)
        y = act(y + b2s[i].float()[None, :, None, None]).to(dt)
        x = x + y.permute(0, 2, 3, 1)
    return x


def kmajor_weights(w1s: torch.Tensor, w2s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layout the CUDA kernels read through TMA: W1 as (n, C/2, C) and W2
    as (n, C, 9*C/2), row ``o`` holding output channel ``o``'s weights (W2's
    K index is tap * C/2 + input channel), from W1 as (n, C, C/2) or
    (n, 1, 1, C, C/2) and W2 as (n, 3, 3, C/2, C) or (n, 9, C/2, C)."""
    n, (c, ch) = w1s.shape[0], w1s.shape[-2:]
    return (w1s.reshape(n, c, ch).transpose(1, 2).contiguous(),
            w2s.reshape(n, 9 * ch, c).transpose(1, 2).contiguous())


def _check_cuda_args(x, w1s, b1s, w2s, b2s, activation, kmajor=None):
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_residual_stage: unsupported activation {activation!r}")
    if x.dim() != 4:
        raise ValueError(f"fused_residual_stage: x must be NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    n, ch = w2s.shape[0], c // 2
    expected = {
        "w1s": (w1s, (n, c, ch), torch.bfloat16),
        "b1s": (b1s, (n, ch), torch.float32),
        "w2s": (w2s, (n, 3, 3, ch, c), torch.bfloat16),
        "b2s": (b2s, (n, c), torch.float32),
        "x": (x, (b, h, w, c), torch.bfloat16),
    }
    if kmajor is not None:
        expected["w1 (K-major)"] = (kmajor[0], (n, ch, c), torch.bfloat16)
        expected["w2 (K-major)"] = (kmajor[1], (n, c, 9 * ch), torch.bfloat16)
    for name, (t, shape, dtype) in expected.items():
        got = tuple(t.shape)
        if name == "w1s" and got == (n, 1, 1, c, ch):
            got = shape
        if got != shape or t.dtype != dtype:
            raise ValueError(
                f"fused_residual_stage: {name} must be {dtype} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != x.device:
            raise ValueError(f"fused_residual_stage: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_residual_stage: {name} must be contiguous and 16-byte aligned")
    if not kernel_takes(h, w, c):
        raise ValueError(
            f"fused_residual_stage: the kernel takes C={KERNEL_C} and "
            f"1 <= W <= {KERNEL_MAX_W}, got H={h}, W={w}, C={c}"
        )


def kernel_takes(h: int, w: int, c: int) -> bool:
    """Whether the CUDA kernel takes an (H, W, C) geometry."""
    return c == KERNEL_C and 1 <= w <= KERNEL_MAX_W and h >= 1


def fused_residual_stage(x, w1s, b1s, w2s, b2s, *,
                         activation: str = "leaky_relu",
                         kmajor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Run a stack of folded residual blocks.

    Args:
        x: (B, H, W, C) activation; bf16 on CUDA.
        w1s: (n, C, C/2) or (n, 1, 1, C, C/2) folded 1x1 weights (bf16 on CUDA).
        b1s: (n, C/2) folded 1x1 biases (f32 on CUDA).
        w2s: (n, 3, 3, C/2, C) folded 3x3 weights, HWIO (bf16 on CUDA).
        b2s: (n, C) folded 3x3 biases (f32 on CUDA).
        kmajor: ``kmajor_weights(w1s, w2s)``, which the CUDA kernel reads;
            made here when not given (a model makes them once).

    Returns (B, H, W, C) in a new tensor; ``x`` is left unchanged.
    """
    global launches
    if x.device.type == "cpu":
        return fused_residual_stage_reference(
            x, w1s, b1s, w2s, b2s, activation=activation
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_stage: unsupported device {x.device}")
    _check_cuda_args(x, w1s, b1s, w2s, b2s, activation, kmajor)
    b, h, w, c = x.shape
    n = w2s.shape[0]
    if b == 0 or n == 0:
        return x.clone()
    lib = load_library()
    stream = stream_handle(x.device)
    w1t, w2t = kmajor if kmajor is not None else kmajor_weights(w1s, w2s)
    # Neighbouring CTAs read each other's halo rows, so a block never
    # writes its input: x, then two buffers in turn.
    bufs = [torch.empty_like(x) for _ in range(min(n, 2))]
    # block i's operands by address: slicing four tensors per launch costs
    # the host more than a small batch costs the card
    operands = (w1t, b1s, w2t, b2s)
    bases = [t.data_ptr() for t in operands]
    steps = [t.stride(0) * t.element_size() for t in operands]
    act = _ACT_CODES[activation]
    src = x
    for i in range(n):
        dst = bufs[i % 2]
        rc = lib.resblock_launch(
            src.data_ptr(), *(base + i * step for base, step in zip(bases, steps)),
            dst.data_ptr(), b, h, w, c, act, stream,
        )
        check(rc, "resblock_launch")
        launches += 1
        src = dst
    return src


def stack_block_params(blocks: Sequence[Dict]) -> Tuple[torch.Tensor, ...]:
    """Per-block folded params ``[{'conv1': {w, b}, 'conv2': {w, b}}, ...]``
    with OIHW torch weights -> the kernel layout ``(w1s, b1s, w2s, b2s)``:
    (n, C, C/2) and (n, 3, 3, C/2, C) in the weights' dtype, f32 biases."""
    w1s = torch.stack([bp["conv1"]["w"][:, :, 0, 0].t() for bp in blocks])
    w2s = torch.stack([bp["conv2"]["w"].permute(2, 3, 1, 0) for bp in blocks])
    b1s = torch.stack([bp["conv1"]["b"] for bp in blocks]).float()
    b2s = torch.stack([bp["conv2"]["b"] for bp in blocks]).float()
    return w1s.contiguous(), b1s, w2s.contiguous(), b2s


def geometry_wins(h: int, w: int, c: int) -> bool:
    """Geometry class the fused stages (this one and the int8 one) are
    routed to: c = 512 and 16^2 <= h*w <= 32^2, i.e. the 26x26x512 stage of
    Darknet-53 at 416px (and its 20x20 to 32x32 sizes at 320-512px). Like
    the JAX router's chunk test, which keeps 13x13x1024 off its kernel, the
    c = 1024 stage (16x16 to 19x19 at 512-608px) stays on the layer path:
    the kernels do not take it. The JAX router's batch gate was a TPU
    measurement and is not applied."""
    return 16 * 16 <= h * w <= 32 * 32 and kernel_takes(h, w, c)


def stage_wins(h: int, w: int, c: int, dtype: torch.dtype, device_type: str) -> bool:
    """Whether a residual stage of this geometry, dtype and device type is
    routed to ``fused_residual_stage``: the geometry class of
    ``geometry_wins`` and, on CUDA, bf16. The CUDA kernel is bf16 only
    (where the JAX kernel casts its weights to ``x.dtype`` and runs), so a
    float32 or float16 stage on CUDA is routed to the layer path (cuDNN)
    by this stated property of its input; a direct call of
    ``fused_residual_stage`` with such a tensor still raises. On the CPU
    the plain version takes every dtype. ``ResidualStage.forward`` asks
    this for each call's own shape; a stage that loses stays on the
    layer-by-layer path."""
    return geometry_wins(h, w, c) and (device_type != "cuda" or dtype == torch.bfloat16)
