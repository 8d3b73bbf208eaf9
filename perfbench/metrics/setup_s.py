"""Seconds from the process's start to the window's: imports, weights and
inputs from the seed, the program's objects, the kernel build on a
checkout's first run, and the warm-up."""


def read(run):
    return run.setup_s
