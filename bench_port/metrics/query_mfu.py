"""The whole query against the card's peak, %: the sum over the window's
completed queries of each one's least time, over the window.

A query's least time is its bytes over the card's memory bandwidth,
counting each base-table column its text references once at the
generated size.
"""
from bench_port.harness import stats


def least_seconds(run, qid) -> float:
    return sum(run.column_bytes[c] for c in run.queries.columns(qid)) \
        / stats.HBM_BYTES_PER_S


def read(run):
    done = run.completed
    if not done or run.window_s <= 0:
        return None
    total = sum(least_seconds(run, r["qid"]) for r in done)
    return 100.0 * total / run.window_s
