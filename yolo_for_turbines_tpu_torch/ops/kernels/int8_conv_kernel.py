"""An s8 convolution as an implicit GEMM (kernel K7, ``csrc/conv_int8.cu``),
its plain torch version, and the router ``models/quantize.py::_conv_i8``
calls.

K7 replaces no TPU kernel: XLA ran the JAX package's int8 convs as int32
convolutions. It computes

    out[b, y, x, n] = sum_{u, v, c} x[b, s*y + u - pad, s*x + v - pad, c] * w[u, v, c, n]

over NHWC s8 codes with zero padding, and writes the exact i32 sums as the
NHWC i32 tensor the conv's epilogue (K6) reads. The plain version is the
int8 layer path's own: an im2col copy in (kh, kw, Cin) order (``unfold``
views, one copy into a buffer whose padding columns are zero) and
``int_mm``. The sums are exact in any order, so the two agree bit for bit.

K7 takes kernel 1 or 3 with pad kernel // 2, stride 1 or 2, Cin a multiple
of 32 and Cout a multiple of 16 (``kernel_takes``); it reads the weights
K-major, (Cout, kh*kw*Cin) with K index (tap, Cin) (``kmajor``), which
``pack_int8`` makes once per conv. Every other conv (the stem: 3
channels, 27 columns; tiny's 16-channel 3x3: 144 columns; any other
kernel, stride or pad) keeps the im2col copy, its columns zero-padded to a
multiple of 32, and runs that matrix through K7 as a 1x1 product
(``route``). A Cout that is not a multiple of 16 is padded with zero
weights to one, and the extra channels are cut from K7's output. Where the
im2col columns divide 128, K7 reads ``g = 128 // kp`` neighbouring rows of
the matrix as one 128-byte row against a block-diagonal weight of ``g``
copies (exact: the other blocks are zeros), and its i32 output is the
(positions, Cout) product in the same memory order; TMA reads 32-byte rows
at a fraction of its rate for 128-byte ones. Where the positions are not a
multiple of ``g``, K7 reads the matrix row by row against the weight's
first block.

On the card ``apply_int8_conv`` launches K7 for every product; it never
gives way to the plain version, which ``models/quantize.py::_conv_i8``
keeps for CPU tensors, ``portable`` and sharded rows. ``int8_conv``
dispatches on the tensor's device: a CPU tensor takes
``int8_conv_reference``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import check, load_library, stream_handle
from .resblock_int8_kernel import int_mm

# kernel launches since the last reset (read by chip_smoke.py and the card tests)
launches = 0

KERNEL_SIDES = (1, 3)
STRIDES = (1, 2)


def kernel_takes(cin: int, cout: int, kernel: int, stride: int, pad: int) -> bool:
    """Whether K7 computes this conv directly from its NHWC input."""
    return (kernel in KERNEL_SIDES and stride in STRIDES and pad == kernel // 2
            and cin >= 32 and cin % 32 == 0 and cout >= 16 and cout % 16 == 0)


def route(cin: int, kp: int, kernel: int, stride: int, pad: int) -> str:
    """How a conv of ``cin`` input channels whose ``_wmat`` has ``kp`` rows
    runs on the card: "direct" (K7 on the NHWC input) or "im2col" (any
    other geometry: the im2col copy, then K7 as a 1x1 product over its
    columns padded to ``im2col_width(kp)``)."""
    if kp == kernel * kernel * cin and kernel_takes(cin, 16, kernel, stride, pad):
        return "direct"
    return "im2col"


def im2col_width(kp: int) -> int:
    """Columns of the im2col matrix K7 reads: ``kp`` rounded up to 32."""
    return -(-kp // 32) * 32


def im2col_group(cin: int, kp: int, kernel: int) -> int:
    """Rows of a conv's im2col matrix that K7 reads as one:
    ``128 // im2col_width(kp)`` where that width divides 128 and the conv's
    channels are not K7's own (a multiple of 32), else 1."""
    width = im2col_width(kp)
    if (kp == kernel * kernel * cin and cin % 32 == 0) or 128 % width:
        return 1
    return 128 // width


def kmajor(wmat: torch.Tensor, cin: int, kernel: int) -> torch.Tensor:
    """``_wmat``'s (kp, Cout) matrix for a conv of ``cin`` input channels as
    the K-major copy K7 reads: (n, w) with n = Cout rounded up to 16 and w =
    ``im2col_width(kp)`` (zero weights past Cout and kp), or for an im2col
    matrix read ``g = im2col_group(...)`` rows at a time, the
    block-diagonal (g*n, g*w)."""
    kp, cout = wmat.shape
    w = F.pad(wmat, (0, -cout % 16, 0, im2col_width(kp) - kp))
    g = im2col_group(cin, kp, kernel)
    return (w if g == 1 else torch.block_diag(*[w] * g)).t().contiguous()


def im2col(xq: torch.Tensor, kernel: int, stride: int, pad: int, kp: int) -> torch.Tensor:
    """(B, H, W, C) s8 -> the (B, Ho, Wo, kp) s8 im2col matrix in (kh, kw,
    Cin) column order, zero-padded past kh*kw*C columns. In NHWC the (kw,
    Cin) columns of one kernel row are ``kernel * C`` contiguous bytes of
    the padded input, so the matrix is ``kernel`` copies of such runs into a
    zeroed buffer."""
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    xq = xq.contiguous()
    b, h, w, c = xq.shape
    ho, wo = (h - kernel) // stride + 1, (w - kernel) // stride + 1
    run = kernel * c
    cols = xq.new_zeros(b, ho, wo, kp)
    sb, sy = xq.stride(0), xq.stride(1)
    for u in range(kernel):
        cols[..., u * run:(u + 1) * run].copy_(xq.as_strided(
            (b, ho, wo, run), (sb, stride * sy, stride * c, 1), xq.storage_offset() + u * sy))
    return cols


def int8_conv_reference(xq: torch.Tensor, wmat: torch.Tensor, kernel: int, stride: int,
                        pad: int) -> torch.Tensor:
    """Plain torch version: NHWC s8 x ``_wmat`` (kh*kw*Cin padded to kp,
    Cout) s8 -> NHWC i32, the im2col copy and ``int_mm`` (a 1x1 conv at
    stride 1 without one)."""
    b, h, w, c = xq.shape
    kp, n = wmat.shape
    if kernel == 1 and stride == 1 and kp == c:
        return int_mm(xq.reshape(-1, c), wmat).view(b, h, w, n)
    cols = im2col(xq, kernel, stride, pad, kp)
    return int_mm(cols.view(-1, kp), wmat).view(*cols.shape[:3], n)


def _check(xq, wk, kernel, stride, pad) -> None:
    if xq.dim() != 4 or xq.dtype != torch.int8:
        raise ValueError(f"int8_conv: x must be an int8 (B, H, W, C) tensor, got "
                         f"{xq.dtype} {tuple(xq.shape)}")
    c = xq.shape[-1]
    if wk.dim() != 2 or wk.dtype != torch.int8 or wk.shape[1] != kernel * kernel * c:
        raise ValueError(f"int8_conv: the K-major weights must be int8 (Cout, "
                         f"{kernel * kernel * c}), got {wk.dtype} {tuple(wk.shape)}")
    if wk.device != xq.device:
        raise ValueError(f"int8_conv: the weights must be on {xq.device}, got {wk.device}")
    if not kernel_takes(c, wk.shape[0], kernel, stride, pad):
        raise ValueError(
            f"int8_conv: the kernel takes kernel 1 or 3 with pad kernel // 2, stride 1 or 2, "
            f"Cin % 32 == 0 and Cout % 16 == 0, got kernel {kernel}, stride {stride}, "
            f"pad {pad}, Cin {c}, Cout {wk.shape[0]}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv: unsupported device {xq.device}")
    for name, t in (("x", xq), ("the weights", wk)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_conv: {name} must be contiguous and 16-byte aligned")


def int8_conv(xq: torch.Tensor, wk: torch.Tensor, kernel: int, stride: int,
              pad: int) -> torch.Tensor:
    """An s8 conv with exact i32 sums.

    Args:
        xq: (B, H, W, Cin) int8, NHWC.
        wk: (Cout, kernel*kernel*Cin) int8, K-major (``kmajor(_wmat(w))``).
        kernel, stride, pad: the conv's geometry (``kernel_takes``).

    Returns (B, Ho, Wo, Cout) int32, NHWC, in a new tensor.
    """
    global launches
    _check(xq, wk, kernel, stride, pad)
    if xq.device.type == "cpu":
        return int8_conv_reference(xq, wk.t(), kernel, stride, pad)
    b, h, w, c = xq.shape
    cout = wk.shape[0]
    ho = (h + 2 * pad - kernel) // stride + 1
    wo = (w + 2 * pad - kernel) // stride + 1
    out = torch.empty(b, ho, wo, cout, dtype=torch.int32, device=xq.device)
    if out.numel() == 0:
        return out
    rc = load_library().int8_conv_launch(xq.data_ptr(), wk.data_ptr(), out.data_ptr(), b, h, w,
                                         c, cout, kernel, stride, stream_handle(xq.device))
    check(rc, "int8_conv_launch")
    launches += 1
    return out


def apply_int8_conv(xq: torch.Tensor, wmat: torch.Tensor, wk: torch.Tensor, kernel: int,
                    stride: int, pad: int) -> torch.Tensor:
    """One int8 conv product through K7 (``route``): the NHWC i32 sums.
    ``wk`` is ``kmajor(wmat, ...)``. A strided or misaligned input is
    copied into a fresh tensor first."""
    if wk is None:
        raise ValueError("int8_conv: the kernel needs the K-major weights (kmajor)")
    kp, cout = wmat.shape
    n = cout + -cout % 16  # the channels K7 writes
    if route(xq.shape[-1], kp, kernel, stride, pad) == "direct":
        if not xq.is_contiguous() or xq.data_ptr() % 16:
            xq = xq.clone(memory_format=torch.contiguous_format)
        y32 = int8_conv(xq, wk, kernel, stride, pad)
    else:
        width = im2col_width(kp)
        cols = im2col(xq, kernel, stride, pad, width)
        b, ho, wo, _ = cols.shape
        g = wk.shape[1] // width
        if (b * ho * wo) % g:
            # rows that do not fill whole groups: the copy's first diagonal block
            g, wk = 1, wk[:n, :width].contiguous()
        y32 = int8_conv(cols.view(-1, 1, 1, g * width), wk, 1, 1, 0).view(b, ho, wo, n)
    return y32 if n == cout else y32[..., :cout].contiguous()
