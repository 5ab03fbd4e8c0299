"""Render a distributed query's journal as timeline / Chrome trace / skew.

Counterpart of the reference's ``scripts/trace_report.py``, over the
port's ``observability.dist`` and ``observability.journal``.  Runs
distributed TPC-H (default Q3) on logical shards of one device, then
serves the query journal four ways and cross-checks it:

* text timeline of the merged span tree (coordinator + fragments +
  replicas + per-shard engine runs + exchanges, one tree per query ID);
* top-operators table (wall time aggregated by span name);
* per-exchange bytes/skew report;
* ``--chrome out.json``: Chrome trace-event JSON loadable in Perfetto /
  chrome://tracing (coordinator = pid 0, shard *s* = pid *s*+1).

Verification (exit 1 on failure):

* ``verify_tree`` structural/temporal checks over the warm run's tree;
* warm root-span wall vs the engine's own ``timers["total"]``;
* single-node ``engine.execute`` journal span vs ``QueryProfile``
  ``total_seconds`` (tolerance: 10% + 25 ms each, the reference's).

``--jsonl FILE`` skips the live run and reads a journal sink written via
``REPRO_JOURNAL_SINK`` / ``attach_sink`` instead (rendering + structural
checks only: engine timers are not in the file).

Run on the card:

    PYTHONPATH=src python -m repro_torch.trace_report [--shards N] [--sf SF]
        [--qid N] [--chrome OUT.json] [--jsonl IN.jsonl] [--query-id ID]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from .observability.dist import (
    exchange_report, query_wall, render_exchange_report, render_timeline,
    render_top_operators, top_operators, verify_tree)
from .observability.journal import JOURNAL, load_jsonl, to_chrome

TOLERANCE_FRAC = 0.10
TOLERANCE_S = 0.025


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--sf", type=float, default=0.004)
    ap.add_argument("--qid", type=int, default=3, help="TPC-H query number")
    ap.add_argument("--chrome", metavar="OUT.json",
                    help="write Chrome trace-event JSON here")
    ap.add_argument("--jsonl", metavar="IN.jsonl",
                    help="analyze an existing journal sink instead of running")
    ap.add_argument("--query-id", help="query ID to report (default: last)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def close_enough(a: float, b: float) -> bool:
    return abs(a - b) <= TOLERANCE_FRAC * max(a, b) + TOLERANCE_S


def report(events, query_id, epoch: float, top: int,
           failures: List[str]) -> None:
    print(f"\n== timeline for {query_id} ==")
    print(render_timeline(events, query_id, epoch=epoch))
    print("\n== top operators ==")
    print(render_top_operators(top_operators(events, query_id, n=top)))
    print("\n== exchanges ==")
    print(render_exchange_report(exchange_report(events, query_id)))
    errors = verify_tree(events, query_id)
    if errors:
        failures.append(f"verify_tree({query_id}): {len(errors)} violations")
        for e in errors[:10]:
            print(f"  VIOLATION: {e}")
    else:
        print(f"\nverify_tree({query_id}): ok")


def _finish(failures: List[str], ok_line: str, out: Dict) -> Dict:
    if failures:
        print(f"\nFAIL: {failures}")
        out["code"] = 1
    else:
        print(f"\n{ok_line}")
        out["code"] = 0
    out["failures"] = failures
    return out


def _write_chrome(path: str, events, epoch: float) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome(events, epoch=epoch), f)
    print(f"chrome trace -> {path}")


def run(argv: Optional[Sequence[str]] = None) -> Dict:
    """Everything ``main`` does; returns the exit code (``code``), the
    failures and, for a live run, the two cross-checks' times in seconds
    (``root_s`` / ``total_s``, ``span_s`` / ``profile_s``)."""
    args = parse_args(argv)
    failures: List[str] = []

    if args.jsonl:
        events = load_jsonl(args.jsonl)
        if not events:
            print(f"error: no events in {args.jsonl}", file=sys.stderr)
            return {"code": 2, "failures": ["no events"]}
        qids = []
        for e in events:
            if e["query_id"] not in qids:
                qids.append(e["query_id"])
        qid = args.query_id or qids[-1]
        epoch = min(e["ts"] for e in events)
        report(events, qid, epoch, args.top, failures)
        if args.chrome:
            _write_chrome(args.chrome,
                          [e for e in events if e["query_id"] == qid], epoch)
        return _finish(failures, "OK", {"query_id": qid})

    from .core.distributed import DistributedEngine
    from .core.executor import SiriusEngine
    from .data.tpch import generate, load_into_engine
    from .data.tpch_queries import QUERIES

    db = generate(args.sf)
    eng = DistributedEngine(db, n_shards=args.shards, device=args.device)
    plan_fn = QUERIES[args.qid]

    print(f"distributed q{args.qid} on {args.shards} shards "
          f"(sf {args.sf}): cold + warm run ...")
    eng.run_plan(plan_fn())            # cold: records, may speculate
    eng.run_plan(plan_fn())            # warm: the run we verify
    qid = args.query_id or eng.last_query_id
    events = JOURNAL.events()

    report(events, qid, JOURNAL.epoch, args.top, failures)

    # cross-check 1: warm root span wall vs the engine's own total timer
    wall, root = query_wall(events, qid)
    total = eng.timers.get("total", 0.0)
    ok = root is not None and close_enough(wall, total)
    print(f"\nroot span {wall * 1e3:.2f} ms vs engine timers total "
          f"{total * 1e3:.2f} ms: {'ok' if ok else 'MISMATCH'}")
    if not ok:
        failures.append("root span wall vs engine timers total")
    out = {"query_id": qid, "root_s": wall, "total_s": total}

    # cross-check 2: single-node engine.execute span vs QueryProfile
    seng = SiriusEngine(device=args.device)
    load_into_engine(seng, db)
    seng.execute(plan_fn())            # cold
    seng.execute(plan_fn(), analyze=True)
    sqid, prof = seng.last_query_id, seng.last_profile
    span_evs = [e for e in JOURNAL.events(sqid)
                if e["name"] == "engine.execute" and e["kind"] == "span"]
    if span_evs and prof is not None:
        span_s = max(e["dur"] for e in span_evs)
        ok = close_enough(span_s, prof.total_seconds)
        print(f"single-node engine.execute span {span_s * 1e3:.2f} ms vs "
              f"QueryProfile total {prof.total_seconds * 1e3:.2f} ms: "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            failures.append("engine.execute span vs QueryProfile total")
        out.update(span_s=span_s, profile_s=prof.total_seconds)
    else:
        failures.append("no single-node engine.execute span / profile")

    if args.chrome:
        _write_chrome(args.chrome, JOURNAL.events(qid), JOURNAL.epoch)

    return _finish(failures, f"OK: journal tree verified for {qid}", out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    return run(argv)["code"]


if __name__ == "__main__":
    sys.exit(main())
