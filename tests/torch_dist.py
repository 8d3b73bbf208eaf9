"""Spawn gloo ranks on the CPU for the port's parallel tests.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes with
``torch.multiprocessing``'s spawn context; each joins a gloo process group
through a file store under ``tmp_path`` (no port to race for between test
workers), runs torch on one thread, calls ``fn(rank, world, *args)`` and
sends back its result. The group's timeout is 60 s, so a collective that
hangs fails in the ranks; the parent waits at most ``timeout`` seconds in
all, kills every rank still alive and raises. ``fn`` must be importable by
name in a fresh process (a module-level function of a module without jax:
``torch_parallel_ranks.py``).
"""

from __future__ import annotations

import datetime
import queue
import time
import traceback

import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60


def _entry(fn, rank, world, store, results, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 150.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]`` from
    ``world`` spawned gloo ranks."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tmp_path / f"store_{time.monotonic_ns()}"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(store), results, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, failed = {}, []
    try:
        while len(out) + len(failed) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(out) - len(failed)} of {world} ranks gave no "
                                   f"result within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None)
                        and r not in out]
                if dead and not failed:
                    failed.append(f"ranks {dead} died: exit codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                    break
                continue
            if ok:
                out[rank] = value
            else:
                failed.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out[r] for r in range(world)]
