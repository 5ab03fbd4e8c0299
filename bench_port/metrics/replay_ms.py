"""Warm replay: mean ``plan_cache.replay`` span (the closure loop or the
CUDA graph, ending in the query's one barrier), ms."""
from statistics import mean

from bench_port.harness.spans import outermost


def read(run):
    spans = outermost(run.spans, "plan_cache.replay")
    return mean(s["dur"] for s in spans) * 1e3 if spans else None
