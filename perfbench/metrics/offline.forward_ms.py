"""Device time per batch of the work launched inside the folded model's
forward (the union of its kernels' and copies' intervals)."""


def read(run):
    t = run.trace
    if t is None or not t.count("model.forward"):
        return None
    return 1e3 * t.busy_s(inside="model.forward") / t.count("model.forward")
