"""Device time per batch of the work launched inside ``predict_batch`` and
outside the model's forward: decode, top-K, NMS (K1) and their copies."""


def read(run):
    t = run.trace
    if t is None or not t.count("perfbench.call"):
        return None
    return 1e3 * t.busy_s(inside="perfbench.call", outside="model.forward") \
        / t.count("perfbench.call")
