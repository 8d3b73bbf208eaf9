"""The host letterbox packer (``letterbox.cpp``), built with ``g++`` at
first use into the git-ignored ``yolo_for_turbines_tpu_torch/_build/`` and
loaded with ctypes.

:func:`batch_letterbox` returns None when the packer cannot be built or
loaded; the caller then takes the numpy + PIL path of ``data/augment.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "letterbox.cpp"
_LIB = Path(__file__).resolve().parents[1] / "_build" / "libletterbox.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_out_pool: dict = {}


def _build() -> bool:
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f".{_LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)  # atomic: a concurrent build never sees half a file
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if missing or stale) and load the packer; None when that fails."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        lib.batch_letterbox_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ]
        lib.batch_letterbox_normalize.restype = None
        _lib = lib
        return _lib


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
    contig = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in contig])
    shs = (ctypes.c_int * n)(*[im.shape[0] for im in contig])
    sws = (ctypes.c_int * n)(*[im.shape[1] for im in contig])
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    lib.batch_letterbox_normalize(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), shs, sws, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        ctypes.c_float(0.0), num_threads,
    )
    return out
