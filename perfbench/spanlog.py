"""Host time from the program's span log (``utils/profiling.py::spans``)."""

from __future__ import annotations

from typing import Optional


def host_ms_per_root(run, root: str, name: str) -> Optional[float]:
    """Host milliseconds in the spans named ``name`` per span named ``root``,
    over the quiet traced window, from its first call's start to its last
    call's end on the host clock; nothing (``None``) when the program logs
    no such span there."""
    from yolo_for_turbines_tpu_torch.utils import profiling

    log = getattr(profiling, "spans", None)
    if log is None or not run.records:
        return None
    got = log(run.records[0][0], run.records[-1][1])
    roots = sum(1 for s in got if s.name == root)
    mine = [s for s in got if s.name == name]
    if not roots or not mine:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in mine) / roots
