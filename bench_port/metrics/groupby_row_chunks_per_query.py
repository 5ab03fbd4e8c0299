"""Kernel backend: ``groupby_sum`` launches on row chunks per completed
query — the ``kernel.groupby_row_chunks`` counter, which a group-by over
more than 2^24 rows adds one to per chunk.  None for a program without
the counter."""

COUNTER = "kernel.groupby_row_chunks"


def read(run):
    n = len(run.completed)
    if not n or COUNTER not in run.counters_after:
        return None
    return run.delta(COUNTER) / n
