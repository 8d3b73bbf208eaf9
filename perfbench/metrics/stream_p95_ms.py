"""The 95th percentile (linear between order statistics) of every
request's time in the window, from the call with a host image to its boxes
on the host."""

import numpy as np


def read(run):
    return float(np.percentile([b - a for a, b, _ in run.records], 95)) * 1e3
