"""Device kernels, copies and memsets launched per request (an exact count
from the trace)."""


def read(run):
    t = run.trace
    if t is None or not t.count("perfbench.call"):
        return None
    return len(t.events(inside="perfbench.call")) / t.count("perfbench.call")
