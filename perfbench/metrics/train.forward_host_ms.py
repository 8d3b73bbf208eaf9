"""Host time per step in ``train_step.forward``: the forward and the loss
under autocast, enqueued.

Read from the program's span log (``utils/profiling.py::spans``) over the
quiet traced window, from its first call's start to its last call's end on
the host clock, summed and divided by the ``train_step`` spans there;
nothing when the program logs no spans (``None``)."""

from yolo_for_turbines_tpu_torch.utils import profiling

ROOT, NAMES = "train_step", ("train_step.forward",)


def read(run):
    log = getattr(profiling, "spans", None)
    if log is None or not run.records:
        return None
    got = log(run.records[0][0], run.records[-1][1])
    roots = sum(1 for s in got if s.name == ROOT)
    if not roots:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in got if s.name in NAMES) / roots
