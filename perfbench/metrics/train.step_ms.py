"""Device time per call of ``Trainer.train_step`` in the quiet traced
window (the union of the intervals of all device work there, which the
steps alone launch)."""


def read(run):
    t = run.quiet
    if t is None or not run.records:
        return None
    return 1e3 * t.busy_s() / len(run.records)
