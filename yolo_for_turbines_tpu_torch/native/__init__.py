"""The host packers (``letterbox.cpp``: the serving letterbox;
``augment.cpp``: the fused train augmenter and the mosaic cutout sampler),
built with ``g++`` into one library in the git-ignored
``yolo_for_turbines_tpu_torch/_build/`` at first use and loaded with ctypes.

Each wrapper returns None when the library cannot be built or loaded; the
caller then takes the numpy + PIL path of ``data/augment.py`` or
``data/mosaic.py``. The ctypes calls release the GIL, so the data loader's
worker threads run them in parallel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRCS = (_DIR / "letterbox.cpp", _DIR / "augment.cpp")
_HEADERS = (_DIR / "bilinear.h",)
_LIB = _DIR.parent / "_build" / "libpacker.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_out_pool: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP, _FP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # srcs, heights, widths, n, dst, size, pad value, threads
    "batch_letterbox_normalize": [ctypes.POINTER(_P), _IP, _IP, _I, _FP, _I, _F, _I],
    # srcs, heights, widths, n, params (n x 9), dst, size, threads
    "batch_train_augment": [ctypes.POINTER(_P), _IP, _IP, _I, _FP, _FP, _I, _I],
    # srcs, heights, widths, resized heights, resized widths, size, y, x, dst
    "mosaic_cutout": [ctypes.POINTER(_P), _IP, _IP, _IP, _IP, _I, _I, _I,
                      ctypes.POINTER(ctypes.c_uint8)],
}


def _build() -> bool:
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f".{_LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", *map(str, _SRCS), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)  # atomic: a concurrent build never sees half a file
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _stale() -> bool:
    if not _LIB.exists():
        return True
    built = _LIB.stat().st_mtime
    return any(p.stat().st_mtime > built for p in _SRCS + _HEADERS)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if missing or stale) and load the packers; None when that fails."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the packers built and loaded (else the numpy + PIL paths run)."""
    return load_library() is not None


def _sources(images: Sequence[np.ndarray]):
    """Contiguous uint8 copies (kept alive by the caller) and their pointer,
    height and width arrays."""
    contig = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    n = len(contig)
    ptrs = (_P * n)(*[im.ctypes.data for im in contig])
    shs = (_I * n)(*[im.shape[0] for im in contig])
    sws = (_I * n)(*[im.shape[1] for im in contig])
    return contig, ctypes.cast(ptrs, ctypes.POINTER(_P)), shs, sws


def batch_letterbox(images: List[np.ndarray], size: int,
                    num_threads: int = 0) -> Optional[np.ndarray]:
    """Letterbox (zero padding) + /255-normalize HWC uint8 images into a
    float32 (N, size, size, 3) batch with the C++ packer; None when it is
    unavailable.

    The batch lives in a buffer pooled by (N, size), which the next call of
    the same shape overwrites: copy it to the device before then."""
    lib = load_library()
    if lib is None:
        return None
    n = len(images)
    out = _out_pool.get((n, size))
    if out is None:
        out = _out_pool[(n, size)] = np.empty((n, size, size, 3), np.float32)
    contig, ptrs, shs, sws = _sources(images)
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    lib.batch_letterbox_normalize(ptrs, shs, sws, n, out.ctypes.data_as(_FP), size,
                                  ctypes.c_float(0.0), num_threads)
    return out


def train_augment(
    image: np.ndarray,
    size: int,
    *,
    do_affine: bool = False,
    scale: float = 1.0,
    dx: float = 0.0,
    dy: float = 0.0,
    flip: bool = False,
    do_hsv: bool = False,
    dh: float = 0.0,
    ds: float = 0.0,
    dv: float = 0.0,
) -> Optional[np.ndarray]:
    """Fused train augmentation of ONE HWC uint8 image: letterbox +
    shift-scale + hflip in a single resample pass, then HSV jitter + /255.

    Returns float32 (size, size, 3), or None when the library is
    unavailable. Box geometry is the caller's (``data/augment.py`` applies
    the same parameters to the labels)."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.float32)
    params = np.asarray(
        [1.0 if do_affine else 0.0, scale, dx, dy, 1.0 if flip else 0.0,
         1.0 if do_hsv else 0.0, dh, ds, dv],
        np.float32,
    )
    contig, ptrs, shs, sws = _sources([image])
    lib.batch_train_augment(ptrs, shs, sws, 1, params.ctypes.data_as(_FP),
                            out.ctypes.data_as(_FP), size, 1)
    return out


def mosaic_cutout(
    images: List[np.ndarray],
    geoms: Sequence[Tuple[int, int]],
    size: int,
    y_pixel: int,
    x_pixel: int,
) -> Optional[np.ndarray]:
    """The (size, size, 3) uint8 mosaic cutout composed straight from the 4
    source images, sampling only the pixels inside the cutout window of the
    (2 * size)^2 canvas.

    ``geoms`` are the 4 resized (nh, nw), computed by the caller with the
    rounding of ``data/augment.py::resize_longest``; (y_pixel, x_pixel) is
    the cutout's top-left in canvas pixels. None when the library is
    unavailable."""
    lib = load_library()
    if lib is None:
        return None
    contig, ptrs, shs, sws = _sources(images)
    n = len(contig)
    nhs = (_I * n)(*[g[0] for g in geoms])
    nws = (_I * n)(*[g[1] for g in geoms])
    out = np.empty((size, size, 3), np.uint8)
    lib.mosaic_cutout(ptrs, shs, sws, nhs, nws, size, y_pixel, x_pixel,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
