"""CUDA kernels: ``topk_select`` against its byte bound, %: the bytes its
calls must move in the window (``kernel.topk_bytes``: each key read once,
each index written once) at the card's memory bandwidth, over the device
seconds of its grids (``topk_tile_kernel``) in the traced window.  None
without a trace, without the counter, or where no grid ran."""
from bench_port.harness import stats

COUNTER = "kernel.topk_bytes"
KERNEL = "topk_tile_kernel"


def read(run):
    if run.trace is None or COUNTER not in run.counters_after:
        return None
    lo, hi = run.trace.to_trace_ns(run.t0), run.trace.to_trace_ns(run.t1)
    ns = sum(min(b, hi) - max(a, lo) for a, b, name in run.trace.device
             if KERNEL in name and b > lo and a < hi)
    moved = run.delta(COUNTER)
    if ns <= 0 or moved <= 0:
        return None
    return 100.0 * moved / stats.HBM_BYTES_PER_S / (ns / 1e9)
