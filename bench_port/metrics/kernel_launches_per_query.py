"""Kernel backend: launches of the hand-written CUDA kernels
(``kernels/build.py::launch_counts``, a replayed graph's included) per
completed query of the window."""


def read(run):
    n = len(run.completed)
    return run.delta("kernel.launches") / n if n else None
