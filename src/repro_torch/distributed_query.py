"""Distributed TPC-H with fault injection: the paper's §3.3 'Distributed'
lifecycle plus the §3.4 fault-tolerance roadmap.

Counterpart of the reference's ``examples/distributed_query.py``.  The
reference spawns itself on 8 forced host devices; here the 8 shards are
logical shards of one device (``DistributedEngine(db, n_shards=8,
device=...)``), so nothing is spawned.  It runs Q1, Q3, Q6 and Q12 at SF
0.005 with the Table-2 timing breakdown, each row count held against the
host ``FallbackEngine``, then kills node 5 during ``q3_join`` and shows
elastic recovery.

Run on the card:

    PYTHONPATH=src python -m repro_torch.distributed_query

``main(device="cpu")`` runs it on the CPU.  It returns, per query, the
row count and timers, and for the fault run the recovered revenues, the
``identical`` flag, ``recoveries`` and the live nodes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .core.distributed import DistributedEngine
from .core.fallback import FallbackEngine
from .data.tpch import generate
from .data.tpch_queries import QUERIES
from .runtime.control import FaultInjector, FaultPlan

SF = 0.005
N_SHARDS = 8
QIDS = (1, 3, 6, 12)


def main(device=None) -> Dict:
    db = generate(SF)
    fb = FallbackEngine(db)
    print(f"== distributed TPC-H on {N_SHARDS} shards ==")
    eng = DistributedEngine(db, n_shards=N_SHARDS, device=device)
    queries = {}
    for qid in QIDS:
        got = eng.run_query(qid)
        t = dict(eng.timers)
        ref = fb.execute(QUERIES[qid]())
        n = len(next(iter(got.values())))
        print(f"Q{qid:2d}: rows={n:3d}  compute={t['compute']*1e3:7.1f}ms  "
              f"exchange={t['exchange']*1e3:7.1f}ms  "
              f"other={t['other']*1e3:7.1f}ms")
        k = next(iter(ref))
        assert len(ref[k]) == n, f"row count mismatch vs oracle on Q{qid}"
        queries[qid] = {"rows": n, "timers": t}

    print("\n== node failure → elastic recovery (§3.4, implemented) ==")
    inj = FaultInjector([FaultPlan(fragment="q3_join", node=5, times=1)])
    eng2 = DistributedEngine(db, n_shards=N_SHARDS, injector=inj,
                             device=device)
    got = eng2.run_query(3)
    ref = fb.execute(QUERIES[3]())
    revenue = np.asarray(got["revenue"], float)
    want = np.asarray(ref["revenue"], float)
    same = bool(np.allclose(revenue, want))
    live = eng2.heartbeat.live_nodes()
    print(f"node 5 killed during q3_join → recovered on "
          f"{eng2.n_shards} shards; result identical: {same}")
    print(f"recoveries={eng2.recoveries}, live nodes={live}")
    return {"queries": queries, "recovered": {
        "n_shards": eng2.n_shards, "revenue": revenue, "want": want,
        "identical": same, "recoveries": eng2.recoveries,
        "live_nodes": list(live)}}


if __name__ == "__main__":
    main()
