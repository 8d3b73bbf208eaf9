"""Images of the steps taken in the window, over its seconds, which end on
a synchronise."""


def read(run):
    return sum(n for _, _, n in run.records) / run.elapsed
