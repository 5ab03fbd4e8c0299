#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
nothing of JAX or of the JAX package ``repro``, and:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the five CUDA kernels from ``src/repro_torch/csrc``;
3. calls each kernel's wrapper on the card at the shapes its main path
   gives it (TPC-H at SF1, ClickBench at 2,000,000 rows), from inputs made
   with a numpy seed, and holds the result against the kernel's plain
   PyTorch version on the same inputs: the filter mask and tile counts, the
   probe rows, the expansion indices and the top-k indices exactly; the
   group-by counts exactly and its other sums to within 2e-7 x sum|v| per
   (group, column): both sum in float64 in different orders and round to
   float32, and a relative tolerance fails on centred sums near zero.
   ``groupby_sum`` is held at Q1's call and at ClickBench q2's one-group
   call, ``join_expand`` at both of Q5's calls and ``topk_select`` at a
   main-path shape and at a 2^20-key shape with heavy ties.  Each kernel,
   its plain version and (for the group-by and the top-k) one library call
   are timed with CUDA events;
4. drives the TPC-H path: SF1 data, ``SiriusEngine(use_kernels=True)`` on
   the card, Q1, Q6, Q3 and Q5 from fresh plans (a cold run and the median
   of three warm runs each).  It holds the per-query kernel hits equal to
   the reference engine's at SF1, checks that every kernel of the path
   launched over this phase, and the results against a
   ``use_kernels=False`` engine on the same card (row-exact for integer,
   date and string columns, rtol 1e-6 for floats);
5. drives the ClickBench path: 2,000,000 rows (seed 20130701) and all 15
   queries through ``SiriusEngine.sql`` (SQL frontend and optimizer), a
   cold run and the median of three warm runs each, on both engines.  It
   holds the per-query kernel hits equal to the reference engine's at this
   scale, checks that ``groupby_sum`` and ``topk_select`` launched in this
   phase, compares the results as in phase 4, and counts device→host copies
   inside pipelines on a warm run of each string query (must be 0);
6. prints the kernels' JSON line, then as its last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before that last line.  Without a CUDA device,
or without the repository around it, it fails.  The full results also go
to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 19920101
SF = 1.0

# H100 SXM published peaks (NVIDIA data sheet):
# device memory rate, and float32 outside the tensor cores, which also
# stands for the scalar integer and compare work these kernels do
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def _hits(filter=0, probe=0, agg=0, expand=0, topk=0) -> dict:
    return dict(filter=filter, probe=probe, agg=agg, expand=expand, topk=topk)


# kernel hits per query on the reference engine at SF1 (Q5 differs at
# SF0.01, where it has probe 4 and expand 1)
EXPECTED_HITS = {
    1: _hits(filter=1, agg=1),
    6: _hits(filter=1, agg=1),
    3: _hits(filter=2, probe=2, agg=1),
    5: _hits(filter=1, probe=3, agg=1, expand=2),
}
ORDER = (1, 6, 3, 5)

# ClickBench: rows of the hits sample and its seed; the kernel hits per
# query on the reference engine at that scale (top-k declines on q12 and
# q14 there: their composite ORDER BY key spans more than 2^24)
CB_ROWS = 2_000_000
CB_SEED = 20130701
CB_AGG = ("q0", "q1", "q2", "q6", "q12", "q14", "q20", "q21", "q43x", "q44x")
CB_TOPK = ("q8", "q21", "q22", "q44x")

# The TPU kernels the CUDA kernels replace (file:line of the pallas_call's
# function in the JAX package)
REPLACES = {
    "filter_mask_counts": "src/repro/kernels/filter_count.py:39",
    "groupby_sum": "src/repro/kernels/groupby_agg.py:48",
    "hash_probe": "src/repro/kernels/hash_probe.py:101",
    "join_expand": "src/repro/kernels/join_expand.py:62",
    "topk_select": "src/repro/kernels/topk.py:60",
}
SOURCES = {
    "filter_mask_counts": "src/repro_torch/csrc/filter_count.cu",
    "groupby_sum": "src/repro_torch/csrc/groupby_agg.cu",
    "hash_probe": "src/repro_torch/csrc/hash_probe.cu",
    "join_expand": "src/repro_torch/csrc/join_expand.cu",
    "topk_select": "src/repro_torch/csrc/topk.cu",
}
# the kernels each main path must launch
PATH_KERNELS = {
    "tpch": ("filter_mask_counts", "groupby_sum", "hash_probe", "join_expand"),
    "clickbench": ("groupby_sum", "topk_select"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms: CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, at the SF1 shapes
# ---------------------------------------------------------------------------


def check_filter(rng, dev) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    n = 5_996_021                                   # lineitem rows, SF1
    ship = rng.integers(8036, 10440, n).astype(np.float32)
    cols = np.stack([ship, ship,
                     rng.integers(0, 11, n).astype(np.float32) / 100,
                     rng.integers(1, 51, n).astype(np.float32)], axis=1)
    below24 = float(np.nextafter(np.float32(24.0), np.float32(-np.inf)))
    lo = [8766.0, -np.inf, 0.05, -np.inf]           # Q6's four conjuncts
    hi = [np.inf, 9130.0, 0.07, below24]
    x = torch.from_numpy(cols).to(dev)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=dev)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=dev)
    mask, counts = ops.filter_mask_counts(x, lo_t, hi_t)
    torch.cuda.synchronize()
    want_mask, want_counts = ref.filter_mask_counts_ref(x, lo_t, hi_t)
    bad = int((mask != want_mask).sum()) + int((counts != want_counts).sum())
    if bad:
        raise AssertionError(f"filter_mask_counts: {bad} mask/count entries "
                             f"differ from the plain version")
    c = cols.shape[1]
    return {
        "name": "filter_mask_counts", "shape": f"N={n}, C={c} (Q6)",
        "max_abs_err": 0.0, "tolerance": "exact",
        "ms": cuda_ms(lambda: ops.filter_mask_counts(x, lo_t, hi_t)),
        "plain_ms": cuda_ms(lambda: ref.filter_mask_counts_ref(x, lo_t, hi_t)),
        "library_ms": None,
        **bound(n * c * 4 + 2 * c * 4 + n + counts.numel() * 4, 2 * n * c),
    }


def _groupby_case(gids: np.ndarray, vals: np.ndarray, g: int, what: str,
                  dev) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    n, v = vals.shape
    gi = torch.from_numpy(gids).to(dev)
    va = torch.from_numpy(vals).to(dev)
    got = ops.groupby_sum(gi, va, g)
    torch.cuda.synchronize()
    # the plain version sums in float64 and rounds once, as the kernel does
    want = ref.groupby_sum_ref(gi, va, g)
    gl = gi.long()
    scale = torch.zeros((g, v), dtype=torch.float64, device=dev).index_add_(
        0, gl, va.double().abs())
    err = (got.double() - want.double()).abs()
    # the counts (column 0) are exact in float32 below 2^24 rows a group;
    # on the other columns the two float64 sums, taken in other orders,
    # round to float32 within an ulp of each other (1.2e-7 x |sum|), while
    # one dropped row of a 2 M-row group is about 5e-7 x sum|v|
    if not torch.equal(got[:, 0], want[:, 0]):
        raise AssertionError(f"groupby_sum ({what}): the count column is not "
                             f"exact")
    rel = (err[:, 1:] / scale[:, 1:].clamp(min=1e-300)).max()
    if not bool((err[:, 1:] <= 2e-7 * scale[:, 1:]).all()):
        raise AssertionError(f"groupby_sum ({what}): error {float(rel):.3g} "
                             f"x sum|v| exceeds 2e-7")
    return {
        "name": "groupby_sum", "shape": f"N={n}, V={v}, G={g} ({what})",
        "max_abs_err": float(err.max()),
        "max_err_over_sum_abs": float(rel),
        "tolerance": "column 0 (counts) exact; the others 2e-7 x sum|v| per "
                     "(group, column)",
        "ms": cuda_ms(lambda: ops.groupby_sum(gi, va, g)),
        "plain_ms": cuda_ms(lambda: ref.groupby_sum_ref(gi, va, g)),
        "library_ms": cuda_ms(lambda: torch.zeros(
            (g, v), dtype=torch.float32, device=dev).index_add_(0, gl, va)),
        **bound(n * 4 + n * v * 4 + g * v * 4, n * v),
    }


def _centred_split(vals: np.ndarray, col: int, x: np.ndarray) -> None:
    """Columns ``col`` and ``col + 1`` of ``vals``: the f32 hi/lo split of
    ``x`` minus its f64 mean, as core/kernel_backend.py builds them."""
    centred = x - x.mean()
    vals[:, col] = centred.astype(np.float32)
    vals[:, col + 1] = (centred - vals[:, col]).astype(np.float32)


def check_groupby(rng, dev) -> dict:
    """The row is Q1's call at SF1 (4 live groups); ClickBench q2's call at
    2,000,000 rows, where every row falls in one group, goes under
    ``other_shapes`` (q0, q1, q20 and q43x call it with one group too)."""
    n, v, g = 5_996_021, 15, 128       # Q1: 4 groups, called with G=128
    gids = rng.integers(0, 4, n).astype(np.int32)
    # the columns core/kernel_backend.py builds for Q1: a ones column, then
    # per sum/avg the f32 hi/lo split of the column minus its f64 mean
    vals = np.empty((n, v), np.float32)
    vals[:, 0] = 1.0
    for k in range(7):
        _centred_split(vals, 1 + 2 * k,
                       rng.integers(1, 10_001, n) * (0.01 * 10 ** (k % 3)))
    q1 = _groupby_case(gids, vals, g, "Q1, 4 live groups", dev)
    # q2: sum(AdvEngineID), count(*), avg(ResolutionWidth) over all rows,
    # with the generator's distributions of the two columns
    n = CB_ROWS
    vals = np.empty((n, 5), np.float32)
    vals[:, 0] = 1.0
    _centred_split(vals, 1, np.where(rng.random(n) < 0.97, 0,
                                     rng.integers(1, 20, n)).astype(np.float64))
    widths = np.array([0, 1024, 1280, 1366, 1440, 1536, 1600, 1920, 2560])
    _centred_split(vals, 3, rng.choice(
        widths, n, p=[0.08, 0.1, 0.18, 0.22, 0.1, 0.08, 0.1, 0.12, 0.02]
    ).astype(np.float64))
    q2 = _groupby_case(np.zeros(n, np.int32), vals, 128,
                       "ClickBench q2 at 2 M rows, 1 live group", dev)
    return {**q1, "other_shapes": [q2]}


def _probe_rounds(keys, slots_row) -> float:
    """Mean probe-chain length these keys walk (for the operation count)."""
    import torch
    from repro_torch.kernels.ref import hash32
    cap = slots_row.shape[0]
    h0 = hash32(keys, cap - 1).long()
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    steps = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    for i in range(32):
        steps += (~done).long()
        done |= slots_row[(h0 + i) & (cap - 1)] == -1
    return float(steps.double().mean())


def check_probe(rng, dev) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    n_build, n_probe = 154_674, 3_049_330            # Q3's lineitem ⋈ orders
    build_keys = rng.choice(6_000_000, n_build, replace=False).astype(np.int64)
    hit = rng.random(n_probe) < 0.2
    probe_keys = np.where(hit, rng.choice(build_keys, n_probe),
                          rng.integers(0, 6_000_000, n_probe)).astype(np.int64)
    bk = torch.from_numpy(build_keys).to(dev)
    nb = ops.bucket_size(n_build)
    valid = torch.arange(nb, device=dev) < n_build
    s, _, ranks, dup, _ = ops.sorted_build(ops.pad_rows(bk, nb), valid)
    sk, sr, placed = ops.build_table32(
        torch.where(valid, ranks, -1).to(torch.int32), valid)
    if bool(dup) or not bool(placed):
        raise AssertionError("hash_probe: synthetic build is not unique/placed")
    p32 = ops.map_probe_keys(s, torch.from_numpy(probe_keys).to(dev))
    row, found = ops.hash_probe(p32, sk, sr)
    torch.cuda.synchronize()
    want_row, want_found = ref.hash_probe_ref(p32, sk, sr)
    bad = int((row != want_row).sum()) + int((found != want_found).sum())
    if bad:
        raise AssertionError(f"hash_probe: {bad} entries differ from the "
                             f"plain version")
    cap = sk.shape[0]
    rounds = _probe_rounds(p32, sr)
    return {
        "name": "hash_probe",
        "shape": f"N={n_probe} keys, build {n_build} rows, capacity {cap} (Q3)",
        "max_abs_err": 0.0, "tolerance": "exact",
        "mean_probe_rounds": rounds,
        "ms": cuda_ms(lambda: ops.hash_probe(p32, sk, sr)),
        "plain_ms": cuda_ms(lambda: ref.hash_probe_ref(p32, sk, sr), iters=5),
        "library_ms": None,
        **bound(n_probe * 4 + cap * 8 + n_probe * 5,
                n_probe * (4 + 3 * rounds)),
    }


def _expand_case(pk: np.ndarray, bk: np.ndarray, what: str, dev) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.relational.join import join_match
    order, lo, counts = join_match(torch.from_numpy(pk).to(dev),
                                   torch.from_numpy(bk).to(dev))
    n = lo.shape[0]
    total = int(counts.sum())
    t_pad = ops.bucket_size(total)
    got = ops.join_expand(order, lo, counts, counts, t_pad)
    torch.cuda.synchronize()
    want = ref.join_expand_ref(order, lo, counts, counts, t_pad)
    bad = sum(int((a[:total] != b[:total]).sum()) for a, b in zip(got, want))
    if bad:
        raise AssertionError(f"join_expand ({what}): {bad} entries differ "
                             f"from the plain version in the first {total}")
    return {
        "name": "join_expand",
        "shape": f"{n} runs, {bk.shape[0]} build rows, {total} outputs "
                 f"in a {t_pad} bucket ({what})",
        "max_abs_err": 0.0, "tolerance": "exact on the first total outputs",
        "ms": cuda_ms(lambda: ops.join_expand(order, lo, counts, counts, t_pad)),
        "plain_ms": cuda_ms(lambda: ref.join_expand_ref(order, lo, counts,
                                                         counts, t_pad)),
        "library_ms": None,
        # counts_out read once for its prefix sum, the three outputs written
        # over the bucket, and lo, counts and order gathered once per output
        **bound(n * 8 + t_pad * 17 + total * 3 * 8,
                t_pad * 2 * n.bit_length()),
    }


def check_expand(rng, dev) -> dict:
    """Q5 calls join_expand twice at SF1; the larger call is the row's
    numbers, the smaller goes under ``other_shapes``."""
    # lineitem ⋈ orders, which try_probe declines (its build of the 1994
    # orders is too large for build_table32): lineitem's orderkeys, sorted as
    # the table is, into ~227,000 distinct orderkeys of 1.5 M orders
    n_orders = 1_500_000
    pk = np.sort(rng.integers(0, n_orders, 5_996_021))
    bk = np.sort(rng.choice(n_orders, 227_000, replace=False)).astype(np.int64)
    large = _expand_case(pk, bk, "Q5 lineitem x orders", dev)
    # the two-key join on (l_suppkey, c_nationkey), combined into one key
    domain = 50_000
    bk = rng.choice(domain, 2_003, replace=False).astype(np.int64)
    pk = rng.integers(0, domain, 968_874)
    small = _expand_case(pk, bk, "Q5 (l_suppkey, c_nationkey) join", dev)
    return {**large, "other_shapes": [small]}


def _topk_case(keys_np: np.ndarray, k: int, what: str, dev) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    keys = torch.from_numpy(keys_np).to(dev)
    got = ops.topk_select(keys, k)
    torch.cuda.synchronize()
    want = ref.topk_select_ref(keys, k)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"topk_select ({what}): {bad} of {k} indices "
                             f"differ from the plain version")
    n = keys.shape[0]
    return {
        "name": "topk_select", "shape": f"N={n}, k={k} ({what})",
        "max_abs_err": 0.0, "tolerance": "exact (indices)",
        "ms": cuda_ms(lambda: ops.topk_select(keys, k)),
        "plain_ms": cuda_ms(lambda: ref.topk_select_ref(keys, k)),
        # its tie order is unspecified: timed, not held
        "library_ms": cuda_ms(lambda: torch.topk(keys, k, largest=False)),
        **bound(n * 4 + k * 4, n),
    }


def check_topk(rng, dev) -> dict:
    """The row is q21's and q22's main-path call at 2,000,000 rows (433
    groups, LIMIT 10; keys are try_topk's composites of a descending count
    and a dictionary code); the 2^20-key call with heavy ties goes under
    ``other_shapes``."""
    n = 433
    counts = rng.integers(1, 20_000, n)
    codes = rng.permutation(n)
    keys = ((counts.max() - counts) * n + codes).astype(np.float32)
    main = _topk_case(keys, 10, "q21/q22 at 2 M rows", dev)
    n = 1_048_573                       # not a multiple of the 1024-key tile
    ties = rng.integers(0, 1000, n).astype(np.float32)
    large = _topk_case(ties, 128, "integers 0..999, heavy ties", dev)
    return {**main, "other_shapes": [large]}


# ---------------------------------------------------------------------------
# phase 4: the TPC-H path
# ---------------------------------------------------------------------------


def compare_tables(got: dict, want: dict):
    """Row-exact for non-float columns, rtol 1e-6 for floats
    → (max relative error, its column)."""
    if set(got) != set(want):
        raise AssertionError(f"columns differ: {sorted(got)} vs {sorted(want)}")
    worst, worst_col = 0.0, None
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape:
            raise AssertionError(f"column {k}: shapes {a.shape} vs {b.shape}")
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(float), b.astype(float),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
            if rel.size and float(rel.max()) >= worst:
                worst, worst_col = float(rel.max()), k
        elif not (a == b).all():
            raise AssertionError(f"column {k}: {a[:5]} vs {b[:5]}")
    return worst, worst_col


def run_main_path() -> dict:
    import torch
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.data.tpch import generate, load_into_engine
    from repro_torch.data.tpch_queries import QUERIES
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    db = generate(SF, seed=SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = SiriusEngine(use_kernels=True)
    load_into_engine(eng, db)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    plain = SiriusEngine(use_kernels=False)
    for name in db:                      # the same device tensors, no copy
        plain.register(name, eng.buffers.get(name))
    emit({"phase": "load", "sf": SF, "generate_s": t_gen, "load_s": t_load,
          "lineitem_rows": eng.buffers.get("lineitem").num_rows,
          "device_bytes": sum(eng.buffers.get(n).nbytes for n in db)})

    def timed(engine, qid):
        t = time.perf_counter()
        out = engine.execute(QUERIES[qid]())
        return out, time.perf_counter() - t

    build.reset_launch_counts()
    results = {}
    for qid in ORDER:
        before = eng.backend.hit_counts()
        launched = build.launch_counts()
        out, cold = timed(eng, qid)
        after = eng.backend.hit_counts()
        hits = {k: after[k] - before[k] for k in after}
        launches = {k: n - launched[k] for k, n in build.launch_counts().items()}
        if hits != EXPECTED_HITS[qid]:
            raise AssertionError(f"Q{qid}: kernel hits {hits}, the reference "
                                 f"engine's at SF1 are {EXPECTED_HITS[qid]}")
        warm = statistics.median(timed(eng, qid)[1] for _ in range(3))
        results[qid] = {"out": out.to_host(), "hits": hits,
                        "launches": launches, "cold_s": cold, "warm_s": warm}
    launches = build.launch_counts()
    missing = [k for k in PATH_KERNELS["tpch"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the TPC-H path: {missing}")

    # the Figure-5 breakdown: profile=True puts a barrier and a timer after
    # every operator (these launches are not counted above)
    prof = SiriusEngine(use_kernels=True, profile=True)
    for name in db:
        prof.register(name, eng.buffers.get(name))

    per_query = []
    for qid in ORDER:
        prof.executor.op_times.clear()
        prof.execute(QUERIES[qid]())
        op_times = dict(prof.executor.op_times)
        ref_out, plain_cold = timed(plain, qid)
        plain_warm = statistics.median(timed(plain, qid)[1] for _ in range(3))
        err, err_col = compare_tables(results[qid]["out"], ref_out.to_host())
        row = {"query": f"Q{qid}", "rows": len(next(iter(ref_out.to_host().values()))),
               "hits": results[qid]["hits"], "launches": results[qid]["launches"],
               "profiled_op_seconds": op_times,
               "cold_s": results[qid]["cold_s"], "warm_s": results[qid]["warm_s"],
               "plain_engine_cold_s": plain_cold, "plain_engine_warm_s": plain_warm,
               "max_rel_err": err, "max_rel_err_column": err_col}
        emit({"phase": "query", **row})
        per_query.append(row)
    return {"launches": launches, "queries": per_query,
            "generate_s": t_gen, "load_s": t_load}


# ---------------------------------------------------------------------------
# phase 5: the ClickBench path (SQL text through the frontend and optimizer)
# ---------------------------------------------------------------------------


def run_clickbench() -> dict:
    import torch
    from repro_torch.core import instrument
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.data import clickbench as cb
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    db = cb.generate(CB_ROWS, seed=CB_SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = SiriusEngine(use_kernels=True)
    cb.load_into_engine(eng, db)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    hits_table = eng.buffers.get("hits")
    plain = SiriusEngine(use_kernels=False)
    plain.register("hits", hits_table)   # the same device tensors, no copy
    cat = cb.clickbench_catalog(CB_ROWS)
    emit({"phase": "clickbench_load", "rows": hits_table.num_rows,
          "columns": len(hits_table.columns), "generate_s": t_gen,
          "load_s": t_load, "device_bytes": hits_table.nbytes})

    def timed(engine, qid):
        t = time.perf_counter()
        out = engine.sql(cb.CLICKBENCH_QUERIES[qid], catalog=cat)
        return out, time.perf_counter() - t

    build.reset_launch_counts()
    runs = {}
    for qid in cb.CLICKBENCH_QUERIES:
        before = eng.backend.hit_counts()
        launched = build.launch_counts()
        out, cold = timed(eng, qid)
        after = eng.backend.hit_counts()
        hits = {k: after[k] - before[k] for k in after}
        want = _hits(agg=int(qid in CB_AGG), topk=int(qid in CB_TOPK))
        if hits != want:
            raise AssertionError(f"ClickBench {qid}: kernel hits {hits}, the "
                                 f"reference engine's at {CB_ROWS} rows are {want}")
        launches = {k: n - launched[k] for k, n in build.launch_counts().items()}
        warm = statistics.median(timed(eng, qid)[1] for _ in range(3))
        runs[qid] = {"out": out.to_host(), "hits": hits, "launches": launches,
                     "cold_s": cold, "warm_s": warm}
    launches = build.launch_counts()
    missing = [k for k in PATH_KERNELS["clickbench"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the ClickBench path: "
                             f"{missing}")

    # device→host copies inside pipelines on a warm run of each string
    # query, and the scalar syncs (pull_scalar) a warm run takes
    for qid in cb.CLICKBENCH_QUERIES:
        syncs = instrument.scalar_syncs.value
        with instrument.track_transfers() as counter:
            timed(eng, qid)
        runs[qid]["scalar_syncs"] = instrument.scalar_syncs.value - syncs
        runs[qid]["transfers"] = {"total": counter.total,
                                  "in_pipeline": counter.in_pipeline}
        if qid in cb.CLICKBENCH_STRING_QIDS and counter.in_pipeline:
            raise AssertionError(f"ClickBench {qid}: {counter.in_pipeline} "
                                 f"device-to-host copies inside pipelines")

    prof = SiriusEngine(use_kernels=True, profile=True)
    prof.register("hits", hits_table)
    per_query = []
    for qid in cb.CLICKBENCH_QUERIES:
        prof.executor.op_times.clear()
        prof.sql(cb.CLICKBENCH_QUERIES[qid], catalog=cat)
        op_times = dict(prof.executor.op_times)
        ref_out, plain_cold = timed(plain, qid)
        plain_warm = statistics.median(timed(plain, qid)[1] for _ in range(3))
        ref_host = ref_out.to_host()
        err, err_col = compare_tables(runs[qid]["out"], ref_host)
        r = runs[qid]
        row = {"query": qid, "rows": len(next(iter(ref_host.values()))),
               "hits": r["hits"], "launches": r["launches"],
               "profiled_op_seconds": op_times,
               "cold_s": r["cold_s"], "warm_s": r["warm_s"],
               "plain_engine_cold_s": plain_cold,
               "plain_engine_warm_s": plain_warm,
               "scalar_syncs_warm": r["scalar_syncs"],
               "transfers_warm": r["transfers"],
               "max_rel_err": err, "max_rel_err_column": err_col}
        emit({"phase": "clickbench_query", **row})
        per_query.append(row)
    if int(runs["q0"]["out"]["c"][0]) != CB_ROWS:
        raise AssertionError(f"q0 counted {runs['q0']['out']['c']} rows")
    return {"launches": launches, "queries": per_query,
            "generate_s": t_gen, "load_s": t_load}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    report = {}
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    report["card"] = {"nvidia_smi": card, "name": kind,
                      "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "card", **report["card"]})

    t0 = time.perf_counter()
    build.lib()
    report["build"] = {"seconds": time.perf_counter() - t0,
                       "nvcc_seconds": build.build_seconds}
    emit({"phase": "build", **report["build"]})
    if build.build_log:
        print(build.build_log, file=sys.stderr)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    kernels = []
    for check in (check_filter, check_groupby, check_probe, check_expand,
                  check_topk):
        row = check(rng, dev)
        emit({"phase": "kernel", **row})
        kernels.append(row)

    report["main_path"] = run_main_path()
    report["clickbench"] = run_clickbench()
    by_path = {"tpch": report["main_path"]["launches"],
               "clickbench": report["clickbench"]["launches"]}
    line = []
    for row in kernels:
        name = row["name"]
        line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
            **({"other_shapes": row["other_shapes"]}
               if "other_shapes" in row else {})})
    report["kernels"] = kernels
    leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "repro" or m.startswith("repro.")]
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — report and fail; never print the ok line
        traceback.print_exc()
        sys.exit(1)
