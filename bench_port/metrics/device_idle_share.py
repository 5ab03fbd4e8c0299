"""Device: the share of the traced window in which no operation ran on the
card, 1 - (union of the profiler's device intervals) / window."""


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_seconds(run.t0, run.t1) / run.window_s
