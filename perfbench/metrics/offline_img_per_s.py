"""Images whose boxes reached the host, over the whole window's seconds."""


def read(run):
    return sum(n for _, _, n in run.records) / run.elapsed
