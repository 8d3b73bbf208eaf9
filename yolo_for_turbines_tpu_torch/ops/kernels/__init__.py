"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` (Hopper), one process per
source, all started together; the objects link into one shared library with
a plain C interface under ``yolo_for_turbines_tpu_torch/_build/``
(git-ignored), at first use and again whenever a source or a header
(``csrc/*.cuh``) is newer than the library. The
library is loaded with ``ctypes``: every pointer and the stream travel as
``c_void_p`` (``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``),
and every entry point returns its ``cudaGetLastError()``, which
:func:`check` turns into an exception.

A failed build raises with nvcc's stderr; nothing here returns None. Only
the kernel wrappers call :func:`load_library`, and only for CUDA tensors, so
importing this package needs neither a card nor a compiler.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIBRARY = BUILD_DIR / "libyolo_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# already up to date)
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # cand, valid, thr, batch, k, center, bits, keep, stream
    "greedy_nms_launch": ([_P, _P, ctypes.c_float, _I, _I, _I, _P, _P, _P], _I),
    # x, w1, b1, w2, b2, out, batch, H, W, C, act, stream
    "resblock_launch": ([_P] * 6 + [_I] * 5 + [_P], _I),
    # x, w1, d1, b1, vm1, w2, d2, b2, vout, rres, out, batch, H, W, C, act, stream
    "resblock_int8_launch": ([_P] * 11 + [_I] * 5 + [_P], _I),
    # boxes, k, center, out, stream
    "pairwise_iou_launch": ([_P, _I, _I, _P, _P], _I),
    # y, bias, skip, rows, C, act, stream
    "conv_epilogue_launch": ([_P, _P, _P, ctypes.c_longlong, _I, _I, _P], _I),
    # y, bias, skip, out, rows, C, pitch, keep, act, stream
    "conv_epilogue_slice_launch": ([_P] * 4 + [ctypes.c_longlong] + [_I] * 4 + [_P], _I),
    # y, yb, res, q, d, db, bias, s_out, rs, rows, C, act, stream
    "int8_epilogue_launch": ([_P] * 9 + [ctypes.c_longlong, _I, _I, _P], _I),
    # x, w, out, batch, H, W, C, cout, kernel, stride, stream
    "int8_conv_launch": ([_P] * 3 + [_I] * 7 + [_P], _I),
    # x, out, windows, slots, batch, H, W, C, stream
    "maxpool_pyramid_launch": ([_P, _P, ctypes.POINTER(_I)] + [_I] * 5 + [_P], _I),
    # x, out, batch, H, W, C, stride, stream
    "maxpool2x2_launch": ([_P, _P] + [_I] * 5 + [_P], _I),
    # x, out, batch, H, W, C, stream
    "maxpool3x3s2_launch": ([_P, _P] + [_I] * 4 + [_P], _I),
    # value, loc, weights, out, shapes, levels, batch, tokens, queries, heads,
    # dim, points, stream
    "deform_attention_launch": ([_P] * 4 + [ctypes.POINTER(_I)] + [_I] * 7 + [_P], _I),
    # src, w0, table, hks, vks, out, size, nh, nw, top, left, band_rows,
    # tile_cols, smem, stream
    "letterbox_launch": ([_P, _I, _P, _I, _I, _P] + [_I] * 8 + [_P], _I),
}


def sources():
    """The translation units: one ``nvcc -c`` each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _inputs():
    """Every file a build reads: the sources and the headers they include."""
    return sources() + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of yolo_for_turbines_tpu_torch are built from "
            f"{CSRC_DIR} at first use"
        )
    return found


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _inputs())


def _run(procs, what: str) -> None:
    """Wait for every (cmd, Popen); raise with the stderr of the failures."""
    errors = []
    for cmd, proc in procs:
        try:
            _, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError(f"{what}:\n" + "\n".join(errors))


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)


def build() -> float:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library;
    returns seconds taken."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    tmp = BUILD_DIR / f".{LIBRARY.name}.{pid}.tmp"
    objects = [BUILD_DIR / f".{src.stem}.{pid}.o" for src in sources()]
    t0 = time.perf_counter()
    try:
        _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
              for src, obj in zip(sources(), objects)], "compiling csrc")
        _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objects)])], "linking the kernel library")
        os.replace(tmp, LIBRARY)  # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build the library if it is missing or stale, load it once, return it."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build_seconds = build()
        lib = ctypes.CDLL(str(LIBRARY))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def stream_handle(device) -> int:
    """The current CUDA stream of ``device`` as the integer a launch takes
    (without building a ``torch.cuda.Stream`` object per launch)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
