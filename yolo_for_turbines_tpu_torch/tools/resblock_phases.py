"""Where the time of one K2 or K4 launch goes, phase by phase, inside its CTAs.

    python -m yolo_for_turbines_tpu_torch.tools.resblock_phases [--kernel k2|k4]
        [--batch 128] [--hw 26]

builds ``csrc/resblock.cu`` (k2, the default) or ``csrc/resblock_int8.cu``
(k4) a second time with ``-DRESBLOCK_PHASES`` (a separate library in
``_build/``; the port's own library has no stamps), runs one residual block
on a seeded 512-channel batch and reads the SM clock that consumer thread 0
of every CTA recorded at each phase boundary. Prints one
JSON line: per phase, the mean time of a CTA in it (us) and its share of a
CTA's time, the mean CTA time, the launch's span on the global timer, the
CTA-time the SMs were busy with over that span, and the launch's time by
CUDA events. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import kernels
from ..ops.kernels import resblock_kernel as rk

# the phase boundaries both kernels stamp (kPhases), in order; a phase is
# named by the boundary that ends it
PHASES = ("start", "first x chunk in", "x tile in", "1x1 products done",
          "own half of mid zeroed", "own half of mid written",
          "3x3 products done", "residual tile in", "output computed", "output stored")
# kernel -> (source, launch entry point, stamp reader)
KERNELS = {
    "k2": ("resblock.cu", "resblock_launch", "resblock_phases"),
    "k4": ("resblock_int8.cu", "resblock_int8_launch", "resblock_int8_phases"),
}


def build(kernel: str = "k2") -> ctypes.CDLL:
    source, launch, reader = KERNELS[kernel]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    library = kernels.BUILD_DIR / f"lib{Path(source).stem}_phases.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DRESBLOCK_PHASES", "-shared", "-o",
           str(library), str(kernels.CSRC_DIR / source)]
    subprocess.run(cmd, check=True, timeout=900)
    lib = ctypes.CDLL(str(library))
    fn = getattr(lib, launch)
    fn.argtypes, fn.restype = kernels._SIGNATURES[launch]
    fn = getattr(lib, reader)
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    return lib


def phase_summary(lib, batch: int, hw: int, sms: int, kernel: str = "k2") -> dict:
    """Mean time per phase of the CTAs of the last launch of ``lib`` (an
    instrumented build of ``kernel``) over a (batch, hw, hw, 512) input, on a
    card of ``sms`` SMs."""
    th = 128 // (hw + 2)
    ctas = (-(-hw // th)) * 2 * batch
    stamps = np.zeros((ctas, len(PHASES) + 2), np.int64)
    reader = KERNELS[kernel][2]
    kernels.check(getattr(lib, reader)(stamps.ctypes.data, ctas), reader)
    clocks, t0, t1 = stamps[:, :len(PHASES)], stamps[:, -2], stamps[:, -1]
    ghz = (clocks[:, -1] - clocks[:, 0]).sum() / (t1 - t0).sum()  # SM cycles per ns
    per_phase_us = np.diff(clocks, axis=1).mean(axis=0) / ghz / 1e3
    cta_us = float((clocks[:, -1] - clocks[:, 0]).mean() / ghz / 1e3)
    span_us = float((t1.max() - t0.min()) / 1e3)
    return {
        "ctas": ctas, "sm_clock_ghz": float(ghz),
        "phases_us": {name: float(us) for name, us in zip(PHASES[1:], per_phase_us)},
        "phase_share": {name: float(us / cta_us) for name, us in zip(PHASES[1:], per_phase_us)},
        "cta_us": cta_us, "span_us": span_us,
        "sm_busy_share": float(ctas * cta_us / (sms * span_us)),
    }


def _k2_launcher(lib, b, hw, dev, rng):
    c, ch = rk.KERNEL_C, rk.KERNEL_C // 2
    x = torch.from_numpy(rng.standard_normal((b, hw, hw, c), np.float32)).to(dev, torch.bfloat16)
    w1 = torch.from_numpy(rng.standard_normal((c, ch), np.float32) / c ** 0.5).to(dev)
    w2 = torch.from_numpy(rng.standard_normal((9 * ch, c), np.float32) / (9 * ch) ** 0.5).to(dev)
    # K-major, as the wrapper hands them over
    w1t, w2t = (w.t().contiguous().to(torch.bfloat16) for w in (w1, w2))
    b1 = torch.zeros(ch, device=dev)
    b2 = torch.zeros(c, device=dev)
    out = torch.empty_like(x)
    stream = kernels.stream_handle(dev)

    def launch():
        kernels.check(lib.resblock_launch(x.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                                          w2t.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                          b, hw, hw, c, 0, stream), "resblock_launch")

    return launch


def _k4_launcher(lib, b, hw, dev, rng):
    c, ch = rk.KERNEL_C, rk.KERNEL_C // 2

    def s8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)

    def row(n, scale):
        return torch.from_numpy(rng.uniform(0.5 * scale, scale, n).astype(np.float32)).to(dev)

    x = s8(b, hw, hw, c)
    w1t, w2t = s8(ch, c), s8(c, 9 * ch)  # K-major, as pack_int8 hands them over
    # scales that keep mid and the output inside the s8 range
    d1, b1, vm1 = row(ch, 2e-4), row(ch, 0.1), row(ch, 30.0)
    d2, b2, vout, rres = row(c, 1e-4), row(c, 0.1), row(c, 30.0), row(c, 0.5)
    out = torch.empty_like(x)
    stream = kernels.stream_handle(dev)

    def launch():
        kernels.check(lib.resblock_int8_launch(
            x.data_ptr(), w1t.data_ptr(), d1.data_ptr(), b1.data_ptr(), vm1.data_ptr(),
            w2t.data_ptr(), d2.data_ptr(), b2.data_ptr(), vout.data_ptr(), rres.data_ptr(),
            out.data_ptr(), b, hw, hw, c, 0, stream), "resblock_int8_launch")

    return launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k2")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=26)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the phase stamps need a CUDA device")
    lib = build(args.kernel)
    dev = torch.device("cuda", 0)
    b, hw = args.batch, args.hw
    launcher = _k2_launcher if args.kernel == "k2" else _k4_launcher
    launch = launcher(lib, b, hw, dev, np.random.default_rng(0))

    for _ in range(3):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    launch_ms = start.elapsed_time(end) / args.iters

    print(json.dumps({"device": torch.cuda.get_device_name(dev), "kernel": args.kernel,
                      "batch": b, "hw": hw, "c": rk.KERNEL_C, "launch_ms": launch_ms,
                      **phase_summary(lib, b, hw, torch.cuda.get_device_properties(dev)
                                      .multi_processor_count, args.kernel)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
