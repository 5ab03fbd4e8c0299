"""Warm replay: the host's dispatch of one warm query, ms — the mean,
over outermost ``plan_cache.replay`` spans, of the start of the replay's
first ``executor.barrier`` child less the replay's start (the closure
loop's Python and launches, or the graph path's pointer checks,
``graph.replay()`` and output clones).  None where the journal lost part
of the window or no replay has a barrier span."""
from statistics import mean

from bench_port.harness.attribution import complete
from bench_port.harness.spans import outermost


def read(run):
    if not complete(run):
        return None
    barrier_at = {}
    for s in run.spans:
        if s["name"] == "executor.barrier":
            p = s["parent_id"]
            barrier_at[p] = min(s["ts"], barrier_at.get(p, s["ts"]))
    gaps = [barrier_at[r["span_id"]] - r["ts"]
            for r in outermost(run.spans, "plan_cache.replay")
            if r["span_id"] in barrier_at]
    return mean(gaps) * 1e3 if gaps else None
