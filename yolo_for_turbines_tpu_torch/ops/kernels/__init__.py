"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All sources compile with ``nvcc`` for ``sm_90a`` (Hopper) into one shared
library with a plain C interface under ``yolo_for_turbines_tpu_torch/_build/``
(git-ignored), at first use and again whenever a source is newer than the
library, the way ``yolo_for_turbines_tpu/native`` builds its packer. The
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# already up to date)
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # boxes, cls, valid, thr, batch, k, keep, stream
    "greedy_nms_launch": ([_P, _P, _P, ctypes.c_float, _I, _I, _P, _P], _I),
    # x, w1, b1, w2, b2, out, batch, H, W, C, act, stream
    "resblock_launch": ([_P] * 6 + [_I] * 5 + [_P], _I),
    "resblock_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "resblock_pad_pixels": ([_I, _I], _I),
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


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
    return any(s.stat().st_mtime > built for s in sources())


def build() -> float:
    """Compile every ``csrc/*.cu`` into the library; returns seconds taken."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIBRARY.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, LIBRARY)  # atomic: a concurrent build never sees half a file
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
    import torch

    return torch.cuda.current_stream(device).cuda_stream
