"""The single-image letterbox on the card (kernel K10, ``csrc/letterbox.cu``),
its tables and its plain numpy version.

K10 replaces no TPU kernel: the JAX package letterboxes on the host with
PIL, as the port's CPU path still does (``data/augment.py::letterbox``). On
the card ``inference.Predictor.predict_image`` uploads the host uint8 frame
as it is and K10 writes the model's (1, S, S, 3) float32 input in one pass:
PIL's bilinear resize of the longest side to S, the centred zero pad and
the division by 255, bit for bit equal to ``letterbox`` followed by
``astype(np.float32) / 255.0``.

That is possible because Pillow's 8-bit resample is integer arithmetic
(``libImaging/Resample.c``): each output is ``clip8((1 << 21) + sum of
pixel * k)``, the sum in int32 and ``clip8`` the shift right by
``PRECISION_BITS`` = 22 clamped to [0, 255], over coefficients that
:func:`pil_bilinear_tables` computes as Pillow's ``precompute_coeffs`` and
``normalize_coeffs_8bpc`` do, in float64 on the host (the card's compiler
would contract ``a * b + c`` into an FMA and could move a rounding). The
horizontal pass runs first, if the width changes, and is rounded to uint8
before the vertical one, if the height changes; a skipped pass is the
identity (one tap of weight ``1 << 22``).

:func:`letterbox_reference` is the plain version of the same two integer
passes in numpy int64; :func:`letterbox` dispatches on the frame's device:
a CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises. :class:`LetterboxTables` keeps each geometry's tables on the device
(a small LRU keyed by ``(h0, w0, S)``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ...data.augment import letterbox_box_geometry
from . import check, load_library, stream_handle

# kernel launches since the last reset (read by chip_smoke.py and the card
# tests)
launches = 0

PRECISION_BITS = 32 - 8 - 2  # Pillow's, for 8-bit images
THREADS = 256  # csrc/letterbox.cu's kThreads: one thread per entry of its 1/255 table
# a CTA's output tile: up to BAND_ROWS rows by TILE_COLS columns of the
# canvas, its horizontal pass held in shared memory as uint8
BAND_ROWS = (16, 8, 4, 2, 1)
TILE_COLS = 64
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 227 * 1024 - THREADS * 4  # beside the kernel's static 1/255 table
# geometries whose tables a predictor keeps on its device
TABLES_KEPT = 8


def pil_bilinear_tables(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's 8-bit bilinear coefficients of one axis: (bounds (out, 2)
    int32, each output's first source index and count of taps; coeffs (out,
    ksize) int32, the taps' weights in fixed point with ``PRECISION_BITS``
    fractional bits, 0 past the count).

    ``precompute_coeffs`` (support 1) and ``normalize_coeffs_8bpc`` in
    float64, operation for operation: the weights summed in tap order as
    Pillow's loop adds them (a pairwise sum can flip the last bit of a
    normalised weight), divided by the sum, then rounded half away from
    zero by truncation. An unchanged axis is Pillow's skipped pass: one tap
    of weight ``1 << PRECISION_BITS``, which the integer pass maps to the
    pixel itself."""
    if in_size < 1 or out_size < 1:
        raise ValueError(f"pil_bilinear_tables: sizes must be positive, got {in_size}, {out_size}")
    if in_size == out_size:
        bounds = np.stack([np.arange(out_size), np.ones(out_size, np.int64)], 1)
        return bounds.astype(np.int32), np.full((out_size, 1), 1 << PRECISION_BITS, np.int32)
    # the box's sides reach the C code as float32
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) truncates toward zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    arg = np.abs(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where(arg < 1.0, 1.0 - arg, 0.0)
    w[taps[None, :] >= xmax[:, None]] = 0.0
    ww = np.zeros(out_size)
    for t in range(ksize):
        ww = ww + w[:, t]
    k = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = k * float(1 << PRECISION_BITS)
    coeffs = np.where(k < 0, -0.5 + fixed, 0.5 + fixed).astype(np.int64)
    return np.stack([xmin, xmax], 1).astype(np.int32), coeffs.astype(np.int32)


def _pass(img: np.ndarray, bounds: np.ndarray, coeffs: np.ndarray, axis: int) -> np.ndarray:
    """One integer pass of Pillow's 8-bit resample along ``axis`` (0 rows,
    1 columns) of an HWC uint8 image; the sums in int64."""
    src = np.moveaxis(img, axis, 0)
    acc = np.full((len(bounds),) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    last = src.shape[0] - 1
    for t in range(coeffs.shape[1]):
        # a tap past the count has weight 0; its index is clamped in place
        at = np.minimum(bounds[:, 0] + t, last)
        acc += src[at].astype(np.int64) * coeffs[:, t].astype(np.int64)[:, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_reference(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Plain version of ``Image.resize((nw, nh), BILINEAR)`` on an HWC uint8
    RGB image: the horizontal pass, then the vertical one."""
    h0, w0 = img.shape[:2]
    img = _pass(img, *pil_bilinear_tables(w0, nw), axis=1)
    return _pass(img, *pil_bilinear_tables(h0, nh), axis=0)


def letterbox_reference(img: np.ndarray, size: int) -> np.ndarray:
    """Plain version of K10: (size, size, 3) float32, ``letterbox(img, None,
    size)[0].astype(np.float32) / 255.0`` from the same integer passes."""
    h0, w0 = img.shape[:2]
    nh, nw, top, left = letterbox_box_geometry(h0, w0, size)
    out = np.zeros((size, size, 3), np.uint8)
    out[top : top + nh, left : left + nw] = resize_reference(img, nh, nw)
    return out.astype(np.float32) / np.float32(255.0)


def check_frame(frame) -> None:
    """Raise unless ``frame`` is an HWC uint8 image with 3 channels and no
    empty side: what K10 takes."""
    shape = tuple(frame.shape)
    if frame.dtype not in (np.uint8, torch.uint8) or len(shape) != 3 or shape[2] != 3:
        raise ValueError(f"letterbox: K10 takes an HWC uint8 frame with 3 channels, got "
                         f"{frame.dtype} {shape}")
    if shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"letterbox: empty frame {shape}")


class Plan(NamedTuple):
    """One geometry's launch: the tables in one int32 device tensor (the
    horizontal bounds and coefficients, then the vertical ones), their
    widths, the letterbox's place on the canvas and the CTA tile."""
    table: torch.Tensor
    hks: int
    vks: int
    nh: int
    nw: int
    top: int
    left: int
    band_rows: int
    tile_cols: int
    smem: int


def _band_span(vbounds: np.ndarray, top: int, nh: int, size: int, rows: int) -> int:
    """The most source rows one band of ``rows`` canvas rows reads."""
    r0 = np.arange(0, size, rows)
    i0 = np.clip(r0 - top, 0, nh)
    i1 = np.clip(np.minimum(r0 + rows, size) - top, 0, nh)
    inside = i1 > i0
    i0, last = i0[inside], i1[inside] - 1
    return int((vbounds[last, 0] + vbounds[last, 1] - vbounds[i0, 0]).max())


def plan(h0: int, w0: int, size: int, device) -> Plan:
    """Tables and tile of one geometry, the tables uploaded to ``device``.

    A CTA keeps its band's horizontal pass in shared memory: the tallest
    band of ``BAND_ROWS`` that fits 48 KB with ``TILE_COLS`` columns, else
    one row by as many columns as fit, down to one column in up to 227
    KB."""
    nh, nw, top, left = letterbox_box_geometry(h0, w0, size)
    hb, hk = pil_bilinear_tables(w0, nw)
    vb, vk = pil_bilinear_tables(h0, nh)
    cols = TILE_COLS
    for rows in BAND_ROWS:
        span = _band_span(vb, top, nh, size, rows)
        if span * cols * 3 <= SMEM_DEFAULT:
            break
    else:
        cols = max(1, min(TILE_COLS, SMEM_DEFAULT // (3 * span)))
        if span * cols * 3 > SMEM_MAX:
            raise ValueError(f"letterbox: a {h0}x{w0} frame needs {span} source rows for one "
                             f"output row, beyond one CTA's shared memory")
    table = np.concatenate([hb.ravel(), hk.ravel(), vb.ravel(), vk.ravel()])
    return Plan(torch.from_numpy(table).to(device), hk.shape[1], vk.shape[1], nh, nw, top, left,
                rows, cols, span * cols * 3)


class LetterboxTables:
    """The plans of the last ``TABLES_KEPT`` geometries ``(h0, w0, S)`` on
    one device, least recently used dropped first; ``builds`` counts the
    plans made."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.builds = 0
        self._plans: OrderedDict = OrderedDict()

    def get(self, h0: int, w0: int, size: int) -> Plan:
        key = (h0, w0, size)
        got = self._plans.get(key)
        if got is not None:
            self._plans.move_to_end(key)
            return got
        got = self._plans[key] = plan(h0, w0, size, self.device)
        self.builds += 1
        if len(self._plans) > TABLES_KEPT:
            self._plans.popitem(last=False)
        return got


def letterbox(frame: torch.Tensor, size: int, tables: LetterboxTables = None) -> torch.Tensor:
    """The model's (1, size, size, 3) float32 input from one HWC uint8 RGB
    frame: PIL's bilinear resize of the longest side, the centred zero pad,
    / 255.

    A CPU frame takes :func:`letterbox_reference`; a CUDA frame launches
    K10 with ``tables``' plan of its geometry (a fresh one without
    ``tables``); a non-contiguous CUDA frame is copied first."""
    global launches
    check_frame(frame)
    if frame.device.type == "cpu":
        return torch.from_numpy(letterbox_reference(frame.numpy(), size))[None]
    if not frame.is_cuda:
        raise ValueError(f"letterbox: unsupported device {frame.device}")
    frame = frame.contiguous()
    h0, w0 = frame.shape[:2]
    p = (tables.get(h0, w0, size) if tables is not None else plan(h0, w0, size, frame.device))
    if p.table.device != frame.device:
        raise ValueError(f"letterbox: tables on {p.table.device}, frame on {frame.device}")
    out = torch.empty((1, size, size, 3), dtype=torch.float32, device=frame.device)
    rc = load_library().letterbox_launch(
        frame.data_ptr(), w0, p.table.data_ptr(), p.hks, p.vks, out.data_ptr(), size, p.nh,
        p.nw, p.top, p.left, p.band_rows, p.tile_cols, p.smem, stream_handle(frame.device))
    check(rc, "letterbox_launch")
    launches += 1
    return out
