#!/usr/bin/env python3
"""Where a warm query's time goes on the GPU, for the PyTorch/CUDA port.

Loads TPC-H (default SF1) into ``repro_torch``'s ``SiriusEngine`` with the
kernel backend on the card, warms each of Q1, Q6, Q3, Q5 once, then runs
each once under ``torch.profiler`` (CPU and CUDA activity); with
``--clickbench`` it does the same for the 15 ClickBench queries through
``SiriusEngine.sql`` on a hits sample of 2,000,000 rows, and with ``--lm``
for decode steps of the LM server (``serve_lm``'s workload: ``llama3.2-3b``
at full width, its batch and cache, the cache filled to ``LM_FILL`` rows;
each step ends in a synchronisation as ``serve``'s steps do).  It prints, per query (or
step), one JSON line with:

* ``wall_ms`` — host wall clock of the profiled run (profiling adds host
  overhead, so this is above the unprofiled warm time of ``chip_smoke.py``);
* ``device_busy_ms`` — the union of the intervals in which a device
  activity (kernel, copy, memset) ran, and ``idle_share`` = 1 - busy/wall;
* ``device_events`` — the number of device activities (launches and copies);
* ``syncs`` — host calls that wait for the device: scalar reads
  (``aten::item``) and barriers (``cudaDeviceSynchronize``);
* ``top_device`` — device time and launches by kernel name, and
  ``top_host`` — host self time by operator, the largest first.

Run on a machine with a card, from the root of a checkout:
``PYTHONPATH=src python3 -m repro_torch.profile_tpch [--sf 1.0] [--out FILE]``
or ``... -m repro_torch.profile_tpch --clickbench`` or ``... --lm``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ORDER = (1, 6, 3, 5)
CB_ROWS = 2_000_000      # the hits sample chip_smoke.py drives
LM_FILL = 300            # cache rows filled before the profiled decode steps
                         # (within serve_lm's prompt lengths, 64-512)
WAITS = ("aten::item", "cudaDeviceSynchronize")


def _busy_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def profile_query(run, top: int) -> dict:
    """Profile one call of ``run()`` (a query on an engine)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    # the executor runs pipelines on worker threads: record them all
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    device, host = defaultdict(float), defaultdict(float)
    launches = defaultdict(int)
    intervals, syncs = [], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            device[e.name] += e.time_range.elapsed_us() / 1e3
            launches[e.name] += 1
        else:
            host[e.name] += e.self_cpu_time_total / 1e3
            syncs += e.name in WAITS
    busy = _busy_ms(intervals)

    def head(d, counts=None):
        return [[k[:90], round(v, 4), *([counts[k]] if counts else [])]
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall if wall else None,
            "device_events": len(intervals), "syncs": syncs,
            "top_device": head(device, launches), "top_host": head(host)}


def _lm_runs():
    """Three decode steps of the server's model at its batch and cache,
    after LM_FILL teacher-forced steps of random tokens."""
    import numpy as np
    import torch
    from .configs import get_config
    from .models.lm import CausalLM
    from .serve_lm import ARCH, BATCH, MAX_CACHE, SEED
    cfg = get_config(ARCH)
    model = CausalLM(cfg, seed=SEED)
    cache = model.init_cache(BATCH, MAX_CACHE)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, LM_FILL + 3))).to(
        model.device)

    def step(i):
        with torch.inference_mode():
            model.decode_step(cache, toks[:, i:i + 1])
        torch.cuda.synchronize()

    for i in range(LM_FILL):
        step(i)
    return ({"arch": cfg.name, "batch": BATCH, "max_cache": MAX_CACHE},
            {f"decode_step_{j}": (lambda i=LM_FILL + j: step(i))
             for j in range(3)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--clickbench", action="store_true",
                    help="profile the ClickBench queries instead of TPC-H")
    ap.add_argument("--lm", action="store_true",
                    help="profile decode steps of the LM server instead")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_tpch: no CUDA device", file=sys.stderr)
        return 2
    from .core.executor import SiriusEngine

    if args.lm:
        scale, runs = _lm_runs()
    elif args.clickbench:
        eng = SiriusEngine(use_kernels=True)
        from .data import clickbench as cb
        cb.load_into_engine(eng, cb.generate(CB_ROWS))
        cat = cb.clickbench_catalog(CB_ROWS)
        scale = {"rows": CB_ROWS}
        runs = {qid: (lambda sql=sql: eng.sql(sql, catalog=cat))
                for qid, sql in cb.CLICKBENCH_QUERIES.items()}
    else:
        eng = SiriusEngine(use_kernels=True)
        from .data.tpch import generate, load_into_engine
        from .data.tpch_queries import QUERIES
        load_into_engine(eng, generate(args.sf))
        scale = {"sf": args.sf}
        runs = {f"Q{qid}": (lambda q=QUERIES[qid]: eng.execute(q()))
                for qid in ORDER}
    lines = []
    for qid, run in runs.items():
        run()                                        # warm
        row = {"query": qid, **scale, "card": torch.cuda.get_device_name(0),
               **profile_query(run, args.top)}
        print(json.dumps(row), flush=True)
        lines.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
