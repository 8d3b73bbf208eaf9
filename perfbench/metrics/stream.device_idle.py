"""The share of the quiet traced window (the device's activity alone) in
which no kernel, copy or memset ran on the device."""


def read(run):
    t = run.quiet
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
