"""Readings that the limits of ``limits/<cell>.json`` are set from: the
numbers a cell compares with the reference, for the program and for its
control (and, for training, for a fault), over many seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 \\
        --variants program control [--seconds 2] [--out chiprun_out/x.jsonl]

Each (variant, seed) builds the cell's driver anew, runs a short window
(at least the calls whose outputs are compared), frees the program's state
and prints one JSON line with the numbers. The benchmark's own runs never
run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def reading(bench, cell, seed: int, variant: str, seconds: float, device) -> dict:
    import torch

    from perfbench import drivers
    from perfbench.run import measure

    cfg, mix = bench.config(cell), bench.mix(cell)
    t0 = time.perf_counter()
    driver = drivers.load(mix["kind"])(cfg, mix, seed, torch.device(device), variant)
    driver.warm()
    records, _ = measure(driver, seconds, limit=None)
    driver.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    return {"cell": cell["name"], "variant": variant, "seed": seed, "calls": len(records),
            "seconds": time.perf_counter() - t0, **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["program", "control"])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from perfbench.manifest import Bench

    bench = Bench.load(ROOT / "BENCHMARK.json")
    cell = bench.cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for variant in args.variants:
            for seed in args.seeds:
                line = json.dumps(reading(bench, cell, seed, variant, args.seconds, args.device))
                print(line, flush=True)
                if out is not None:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
