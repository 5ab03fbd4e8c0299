#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
nothing of JAX or of the JAX package ``repro``, and:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc``: the six that
   replace the TPU kernels, and ``count_distinct``, which replaces none;
3. calls each kernel's wrapper on the card at the shapes its main path
   gives it (TPC-H at SF1, ClickBench at 2,000,000 rows), from inputs made
   with a numpy seed, and holds the result against the kernel's plain
   PyTorch version on the same inputs: the filter mask and tile counts, the
   probe rows, the expansion indices and the top-k indices exactly; the
   group-by counts exactly and its other sums to within 2e-7 x sum|v| per
   (group, column): both sum in float64 in different orders and round to
   float32, and a relative tolerance fails on centred sums near zero.
   ``groupby_sum`` is held at Q1's call, at ClickBench q2's one-group
   call, at Q3's call at SF1 (16,384 groups) and at Q13's at SF10 (2^21),
   the last two one-pass, ``hash_probe`` at Q3's second
   call (~1% hits, the rest the absent rank -2), at a 20%-hit case of the
   same size and at Q5's third call (every key hits), ``join_expand`` at
   both of Q5's calls and at a skewed case, over the whole bucket (filler
   included), ``topk_select`` at a
   main-path shape and at a 2^20-key shape with heavy ties,
   ``count_distinct`` exactly at 2^24 rows of ClickBench q4's user ids in
   one group and by q9's regions, and at q4's and q9's calls of
   ``clickbench-hits.hot`` (99,997,497 rows, 17,630,976 users), and
   ``decode_attention`` at the server's shape (batch 8, llama3.2-3b's
   heads, an 8192-row bf16 cache), at 32,768 rows (batch 4, and batch 1),
   in float32 with group 7 and at phase 6b's group 4 (phi3.5-moe's and
   jamba's 32 and 8 heads): 2e-5 in float32 and 3e-2 in bf16 (the
   reference's tolerances) against the plain version, and in bf16 also
   element by element against the plain version on the inputs cast to
   float32, unrounded, within half a bf16 ulp of that value plus 1e-5
   (``decode_limit_ratio``).  Two
   deliberately wrong versions are read against the same limit (scores
   rounded to bf16; each row's last valid position dropped), and the
   second must fail it.  Each kernel, its plain version
   and (for the group-by, the top-k, the count distinct and the decode
   attention) one library call are timed with CUDA events; the kernel's
   own grids also with
   torch.profiler over the same loop (``device_ms``), the wrapper's host
   time with the host clock (``host_ms``) and, for ``hash_probe``, one call
   with the card's L2 evicted (``evicted_ms``).  Each kernel's check runs
   in a process of its own (``run_check``);
4. drives the TPC-H path: SF1 data, ``SiriusEngine(use_kernels=True,
   compile_pipelines=False)`` (the eager path) on the card, Q1, Q6, Q3 and
   Q5 from fresh plans (a cold run and the median of three warm runs each).  It holds the per-query kernel hits equal to
   the reference engine's at SF1, checks that every kernel of the path
   launched over this phase, and the results against a
   ``use_kernels=False`` engine on the same card (row-exact for integer,
   date and string columns, rtol 1e-6 for floats).  A profiled run records
   the shape of every ``groupby_sum`` and ``hash_probe`` call;
4b. drives the reference's default path over all 22 TPC-H queries on
   phase 4's SF1 tensors (registered again, not copied), on three engines:
   ``SiriusEngine(use_kernels=True)`` and ``SiriusEngine()`` (the default
   ``compile_pipelines=True``: fused regions, the executable-plan cache)
   and the eager ``compile_pipelines=False`` engine as the yardstick.  Each
   hand-built plan cold once and warm three times, every result held
   against the yardstick's as in phase 4; the kernel hits of each cold run
   equal to ``EXPECTED_HITS_SF1``; every warm run a plan-cache replay with
   one barrier and no scalar sync, by one CUDA graph on ``SiriusEngine()``
   for the queries in ``EXPECTED_GRAPH_QIDS`` and by the closure loop
   otherwise; no device→host copy inside a pipeline on a warm run; the four
   TPC-H kernels launched in the phase.  Then the 22 SQL texts through
   ``eng.sql`` on both compiled engines: the second call must skip the
   parser and equal the hand-built result.  It prints one line per query
   (cold and warm seconds per engine, replay mode, hits, launches) and one
   with the memory the graph engine's entries hold;
5. drives the ClickBench path: 2,000,000 rows (seed 20130701) and all 15
   queries through ``SiriusEngine.sql`` (SQL frontend and optimizer), a
   cold run and the median of three warm runs each, on both engines (the
   eager path, as phase 4).  It
   holds the per-query kernel hits equal to the reference engine's at this
   scale, checks that ``groupby_sum`` and ``topk_select`` launched in this
   phase, compares the results as in phase 4, and counts device→host copies
   inside pipelines on a warm run of each string query (must be 0);
5b. drives the drop-in front door: the 37 golden Substrait wire plans of
   ``tests/golden/substrait`` (read as data files) through
   ``SiriusEngine.accelerate`` on phase 4's SF1 tensors and phase 5's
   ``hits`` table, registered again with their host dicts.  The 22 TPC-H
   wires run on ``SiriusEngine(use_kernels=True)`` and ``SiriusEngine()``,
   the 15 ClickBench wires on the kernel engine: each cold once and warm
   twice, then the same query's SQL text on the same engine, every result
   held against the eager engine's ``sql()`` as in phase 4; each report
   one device fragment with no boundary bytes; each warm run a plan-cache
   hit by the wire bytes with one barrier and no scalar sync, one CUDA
   graph on ``SiriusEngine()``; no device→host copy inside a pipeline; the
   cold run's kernel hits equal to the SQL text's on the same plan (phase
   4b's first call, or the text through the default catalog where the
   engine's dictionary-costed optimizer chose another plan) and, for
   ClickBench, ``CB_AGG`` / ``CB_TOPK``.  Then four hybrid plans of
   ``tests/test_substrait.py`` (a ``row_number`` window, a ``UNION ALL``,
   Q13 with LIKE host-only, a host-rooted window sum) on the kernel
   engine: the reference's fragment placements and deps, boundary bytes
   equal to the buffer manager's counters, results against the port's
   ``FallbackEngine`` on the host dicts (Q13: the eager ``sql()``), each
   fragment's seconds.  No plan may fall back; the five SQL kernels must
   launch in the phase;
5c. drives EXPLAIN ANALYZE on the same tensors (registered again with their
   host dicts): each of the 22 hand-built plans through
   ``execute(plan, analyze=True)`` on ``SiriusEngine(use_kernels=True)`` and
   ``SiriusEngine()`` after a cold plain run, twice (the second is
   reported), each result held against the eager yardstick, each profile
   valid with its last sink's ``rows_out`` the result's rows, more than one
   barrier a run, the ``kernel.*_hits`` deltas equal to
   ``EXPECTED_HITS_SF1`` on the kernel engine, and every fused operator
   that ran carrying ``est_flops`` and ``est_bytes`` (some on each engine);
   after it, each plain warm run still a plan-cache replay with one
   barrier and no scalar sync (one CUDA graph on ``SiriusEngine()``).  The
   15 ClickBench queries through ``sql(text, analyze=True)`` on the kernel
   engine with ``CB_AGG`` / ``CB_TOPK`` hits; ``sql("EXPLAIN ANALYZE " +
   Q6)``; ``accelerate(wire, analyze=True)`` on Q3's golden wire and the
   four hybrid plans, each one merged profile whose fragments keep no
   ``_profile``.  Then warm replays of Q1 and Q6 on both engines with the
   journal on and off in turn (31 each): one barrier, no scalar sync, no
   transfer bytes, no copy in a pipeline, and the median with it on within
   ``t_off * 1.05 + 2 ms``; and the journal calls of a warm run timed
   alone, on and off.  Q3's ``pretty()`` and a Chrome trace of Q3's
   SQL text go to ``build/``; the kernels of both SQL paths must launch;
5d. drives distributed execution: ``DistributedEngine`` over phase 4's
   SF1 host dicts and phase 5's ``hits`` on ``DIST_SHARDS`` logical shards
   that share the card (an exchange is a permutation in device memory and
   a host round trip through the registry, not NVLink): the 22 hand-built
   TPC-H plans with ``use_kernels=True`` and again without, and the 15
   ClickBench queries with the kernels, each cold once and warm three
   times, every result held against the eager engine over phase 4's and
   5's tensors (integer, date and string columns row-exact, floats within
   ``DIST_RTOL``); no shard may fall back to the host, each query's journal
   tree must verify, the TPC-H sweep must launch ``filter_mask_counts``,
   ``hash_probe``, ``groupby_sum`` and ``join_expand`` (ClickBench
   ``groupby_sum``; its ORDER BY ... LIMIT tails run on the coordinator's
   host engine, as in the reference) and the generic sweep none.  Then
   the fault scenarios of ``tests/_dist_worker.py`` on
   ``DIST_FAULT_SHARDS`` shards at SF1, Q3: checkpoint resume, node
   failure (one recovery, one shard fewer), a straggler (its fragment
   speculated, and the late primary never runs), predicate transfer on Q3
   and Q10 (where it must prune rows); prime
   row counts (Q1, Q3, Q6, Q12, Q18) and an overflowing shuffle that
   retries with doubled buckets.  It prints one line per query (fragments,
   exchanges with their bytes per shard, skew and rows, the timers, cold
   and warm ms) and the phase's seconds and peak device memory;
5e. drives the SQL half of ``launch/``: the dry run of the ten SQL cells
   (``q1``, ``q3``, ``q3pt``, ``q3c``, ``q3ptc`` at SF100 on 256 and 2 x
   256 shards) under fake CUDA tensors, one line a cell (caps, shuffle
   caps, per-shard argument / output / peak bytes, bytes accessed,
   collective bytes by kind, ``fits_card``); then the same fragments run
   for real with SF100 / 256's per-shard caps on ``n`` logical shards of
   the card, ``n`` the largest power of two in 8..256 whose predicted
   ``n x`` per-shard peak stays under ``LAUNCH_MEM_SHARE`` of its memory
   (SF = 100 n / 256; two pods of n / 2 for the multi-pod mesh), on data
   made on the card from ``LAUNCH_SEED`` in dbgen's domains.  Each run is
   held against the plain global answer (``launch/sql_data.py``): Q1's
   9 x 6 sums within ``LAUNCH_Q1_RTOL``; Q3's overflow equal to the plain
   count of rows past their buckets, exactly, 0 for ``q1``, ``q3`` and
   ``q3c``; where it is 0, each shard's top-10 to the plain answer for the
   keys hashed to it (revenue within ``LAUNCH_Q3_RTOL``).  It prints per
   run the cold and the warm (median of 3) ms, the measured peak against
   the predicted ``n x`` per-shard peak, the bytes accessed over 3.35 TB/s
   against the warm ms, and for the ``pt`` variants the overflow and the
   Bloom filter's pass fraction;
6. drives the LM serving path: ``serve_lm``'s workload (``llama3.2-3b``
   at full width, 28 layers, random bf16 weights from its seed) on the
   card.  For models and tokens from three seeds, teacher-forced
   ``decode_step`` logits (through the decode-attention kernel) are held
   against the parallel forward's (plain blockwise attention) on 2 prompts
   of 256 tokens: max |delta log-softmax| within ``LOGPROB_LIMIT``, and the
   greedy tokens equal wherever the forward's top-2 margin exceeds twice
   it (an error within the limit moves a margin by at most twice it).
   Then ``serve`` answers the workload's 8 requests (prompts of 64-512
   tokens, 32 new tokens each, an 8192-row cache), the kernel must launch
   once per layer and step, and every generated token is held against the
   forward's greedy choice over the same sequence in the same way.  It
   prints the prefill and decode tokens/s, the median decode step and the
   peak device memory;
6b. drives the MoE, MLA and Mamba families at full width, one after the
   other with the card's memory freed between them: ``phi3.5-moe-42b-a6.6b``
   (16 of 32 layers served), ``deepseek-v2-lite-16b`` (all 27),
   ``falcon-mamba-7b`` (all 64) and ``jamba-v0.1-52b`` (16 of 32: two
   periods of 8), random weights from ``serve_lm``'s seed
   (``FAMILY_LAYERS``).  For each: (a) in float32 at a cut depth (8, 9, 64
   and 8 layers; the capacity factor E / k, so the forward drops no token)
   teacher-forced ``decode_step`` against the forward as in phase 6, within
   ``LOGPROB_LIMIT_F32``, greedy tokens at twice it, each row up to its
   first token that the two paths route to other experts at a router
   logit tie (margin under ``ROUTE_TIE``); (b) falcon-mamba only, phase
   6's bf16 check at 64 layers, read against ``LOGPROB_LIMIT`` and not
   held (the reference's own bf16 forward and decode differ by more); (c)
   ``serve`` answers phase 6's workload in bf16 at the served depth:
   ``decode_attention`` must launch once per attention layer and step (16
   and 2 a step for phi3.5-moe and jamba, 0 for the other two), tokens in
   ``[0, vocab)``, and every served token equal to the argmax of a
   teacher-forced ``decode_step`` re-run over the same padded sequence in
   the same batch.  It prints weight bytes and params, init
   seconds, prefill and decode tokens/s, the median decode step, the peak
   device memory, the launches and the family's seconds;
6c. and 6d. drive whisper-medium and llava at full depth, and training
   (``run_lm_encdec``, ``run_training``: their docstrings say what is held);
6e. drives the model half of ``launch/``: the dry run of seven model cells
   on the 16 x 16 mesh (``MODEL_DRY_CELLS``: every kind and family),
   each shard's program counted on ``meta`` tensors on this machine, one
   line a record, every count equal to the CPU sweep's
   (``tests/golden/dryrun_models_pod.json``; where this machine's PyTorch
   release is another than the one that wrote it, the counts its own
   backward formulas move within ``model_dryrun.RELEASE_RTOL``); then
   llama3.2-3b's
   ``train_4k`` and ``prefill_32k`` shard programs run once for real on the
   card (pieces drawn from ``serve_lm``'s seed, the collectives returning
   tensors of their result's shape), each measured peak within
   ``MODEL_PEAK_RTOL`` of the record's ``resident_bytes_per_chip``;
7. drives the reference's public surface as the port's entry points
   (``run_examples``): ``repro_torch.quickstart.main`` at SF 0.01 with the
   kernels, its SQL result and hand-built revenues held against the eager
   ``use_kernels=False`` engine on the card as in phase 4, Q3's SQL path
   equal to its plan, the kernel hits equal to the CPU run's
   (``QUICKSTART_HITS``, pinned against the reference by
   ``tests/test_torch_examples.py``) and the fallback over a table only
   the host holds on the host with ``s == 6``; ``distributed_query.main``
   on 8 logical shards at SF 0.005, its row counts ``EXAMPLE_ROWS`` and the
   recovered Q3's revenues against ``FallbackEngine``'s (rtol 1e-6), no
   recovery and every node live, as on the CPU; ``trace_report`` on Q3 at 4
   shards, which must exit 0 (its three verifications, the reference's
   tolerances).  It prints each part's ms, the trace report's two margins
   and the phase's seconds; the parts' printed text goes to ``build/``;
8. prints the kernels' JSON line, then as its last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before that last line.  Without a CUDA device,
or without the repository around it, it fails.  The full results also go
to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
SEED = 19920101
SF = 1.0

# H100 SXM published peaks (NVIDIA data sheet):
# device memory rate, and float32 outside the tensor cores, which also
# stands for the scalar integer and compare work these kernels do
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# and the dense bf16 rate of its tensor cores, for a decode step's products
BF16_OPS_PER_S = 989e12


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

# phase 4b, the reference's default path over the 22 queries at SF1: the
# kernel hits per query of ``SiriusEngine(use_kernels=True)`` with its
# default compile_pipelines=True, on its cold run (the port's own reading
# on the card, PERF.md §5.  They differ from the reference's at SF0.01
# (tests/test_torch_tpch_compiled.py) where the data change the routing:
# at SF1 build_table32 declines a probe table or more in Q4, Q5, Q8, Q9,
# Q12, Q14, Q17, Q19, Q21 and Q22, whose joins then run eagerly (the inner
# ones through join_expand), and Q19's group-by and Q21's top-k reach
# their kernels; and where the port's kernel backend takes the group-bys
# with a count distinct, Q16's and Q21's two, which the reference's
# declines), and the queries whose warm replay on
# ``SiriusEngine()`` must be one CUDA graph (the reference compiles the
# replay of every one of the 22 where no kernel backend is attached;
# tests/test_torch_tpch_compiled.py pins this set to the reference's)
EXPECTED_HITS_SF1 = {
    1: _hits(filter=1, agg=1), 2: _hits(probe=7, agg=1),
    3: _hits(filter=2, probe=2, agg=1), 4: _hits(filter=1, agg=1),
    5: _hits(filter=1, probe=3, agg=1, expand=2), 6: _hits(filter=1, agg=1),
    7: _hits(filter=1, probe=5, agg=1),
    8: _hits(filter=1, probe=6, agg=1, expand=1),
    9: _hits(probe=3, agg=1, expand=2), 10: _hits(filter=1, probe=3),
    11: _hits(probe=4, agg=2), 12: _hits(agg=1, expand=1),
    13: _hits(agg=2, expand=1), 14: _hits(filter=1, agg=1, expand=1),
    15: _hits(filter=2, probe=1, agg=3), 16: _hits(probe=2, agg=1),
    17: _hits(probe=1, agg=2, expand=1), 18: _hits(probe=3, agg=1),
    19: _hits(agg=1, expand=1), 20: _hits(filter=1, probe=3, agg=1, expand=1),
    21: _hits(probe=3, agg=3, topk=1), 22: _hits(agg=2),
}
EXPECTED_GRAPH_QIDS = frozenset(range(1, 23))
WARM_RUNS = 3

# ClickBench: rows of the hits sample and its seed; the kernel hits per
# query at that scale (the reference engine's, but for top-k on q12 and
# q14: their composite ORDER BY key spans more than 2^24, where the
# reference declines and the port ranks in int64)
CB_ROWS = 2_000_000
CB_SEED = 20130701
CB_AGG = ("q0", "q1", "q2", "q6", "q12", "q14", "q20", "q21", "q43x", "q44x")
CB_TOPK = ("q8", "q12", "q14", "q21", "q22", "q44x")
# the group-bys with a count distinct, which the port's kernel backend takes
# (count_distinct) and the reference's declines
CB_DISTINCT = ("q4", "q5", "q8", "q10", "q22")


def _cb_hits(qid: str) -> dict:
    """The kernel engine's hits on ClickBench query ``qid``."""
    return _hits(agg=int(qid in CB_AGG or qid in CB_DISTINCT),
                 topk=int(qid in CB_TOPK))


# The TPU kernels the CUDA kernels replace (file:line of the pallas_call's
# function in the JAX package)
REPLACES = {
    "filter_mask_counts": "src/repro/kernels/filter_count.py:39",
    "groupby_sum": "src/repro/kernels/groupby_agg.py:48",
    "hash_probe": "src/repro/kernels/hash_probe.py:101",
    "join_expand": "src/repro/kernels/join_expand.py:62",
    "topk_select": "src/repro/kernels/topk.py:60",
    "decode_attention": "src/repro/kernels/decode_attention.py:68",
    "count_distinct": None,   # no TPU counterpart: the reference sorts pairs
}
# the names of each kernel's grids, as torch.profiler reports them (for
# groupby_sum, the register/shared grid, the one-pass design's row and
# finishing grids, and the two grids of its earlier design, so that
# kernel_turns.py can time a checkout that has it; hash_probe_kernel is the
# narrow grid of hash_probe and the only grid of its earlier design)
DEVICE_NAMES = {
    "filter_mask_counts": ("filter_mask_counts_kernel",),
    "groupby_sum": ("groupby_sum_kernel", "groupby_sum_wide_kernel",
                    "groupby_sum_finish_kernel", "groupby_partial_kernel",
                    "groupby_merge_kernel"),
    "hash_probe": ("hash_probe_kernel", "hash_probe_wide_kernel"),
    "join_expand": ("join_expand_kernel",),
    "topk_select": ("topk_tile_kernel",),
    "decode_attention": ("decode_attention_kernel",),
    "count_distinct": ("count_distinct_insert_kernel",),
}
SOURCES = {
    "filter_mask_counts": "src/repro_torch/csrc/filter_count.cu",
    "groupby_sum": "src/repro_torch/csrc/groupby_agg.cu",
    "hash_probe": "src/repro_torch/csrc/hash_probe.cu",
    "join_expand": "src/repro_torch/csrc/join_expand.cu",
    "topk_select": "src/repro_torch/csrc/topk.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "count_distinct": "src/repro_torch/csrc/count_distinct.cu",
}
# the kernels each main path must launch
PATH_KERNELS = {
    "tpch": ("filter_mask_counts", "groupby_sum", "hash_probe", "join_expand"),
    "clickbench": ("groupby_sum", "topk_select", "count_distinct"),
    "lm_serve": ("decode_attention",),
    "front_door": ("filter_mask_counts", "groupby_sum", "hash_probe",
                   "join_expand", "topk_select"),
    "analyze": ("filter_mask_counts", "groupby_sum", "hash_probe",
                "join_expand", "topk_select"),
    # ORDER BY ... LIMIT runs on the coordinator's host engine, as in the
    # reference, so the distributed ClickBench path has no top-k
    "distributed_tpch": ("filter_mask_counts", "groupby_sum", "hash_probe",
                         "join_expand"),
    "distributed_clickbench": ("groupby_sum",),
}
# phase 5d: the logical shards of the distributed sweeps and of the fault
# scenarios (tests/_dist_worker.py's 8); partial aggregates re-associate
# float sums across shards, so floats are held at that worker's rtol 2e-5
# (atol 1e-6); the least injected straggler delay; the timers each
# query's line prints
DIST_SHARDS = 4
DIST_FAULT_SHARDS = 8
# warm runs of the generic (no-kernel) TPC-H sweep, which no kernel row reads
DIST_GENERIC_WARM_RUNS = 1
DIST_RTOL = 2e-5
STRAGGLE_S = 2.0
DIST_TIMERS = ("compute", "exchange", "compile", "other", "total")
# phase 5e: the seed of the fragments' data, the share of the card's memory
# the real runs may fill (by the dry run's prediction), and the shard
# counts tried; Q1's float32 sums take at most five float32 roundings a
# term (1 - discount, the discounted price, 1 + tax, the charge, and the
# sum itself, which the card adds in fixed point), Q3's line revenues at
# most three (1 - discount, the product, and the code's * 0.01), summed in
# float64
LAUNCH_SEED = 19920101
LAUNCH_MEM_SHARE = 0.6
LAUNCH_SHARDS = (256, 128, 64, 32, 16, 8)
LAUNCH_Q1_RTOL = 6 * 2.0 ** -24
LAUNCH_Q3_RTOL = 4 * 2.0 ** -24
# phase 5c: the warm replays a query runs with the journal on and with it
# off, and the calls of a warm run's journal spans timed alone
JOURNAL_REPEATS = 31
SPAN_CALLS = 20_000

# decode_attention in bf16 against the plain version on float32 inputs:
# the kernel rounds a float32 result once, which moves it by at most half
# a bf16 ulp (<= 2^-8 of its size); float32 sums in another order add far
# less than 1e-5 at these lengths
BF16_HALF_ULP, F32_NOISE = 2.0 ** -8, 1e-5

# the LM serving path runs serve_lm's workload (ARCH, BATCH, PROMPT_LENS,
# N_NEW, MAX_CACHE, SEED); the decode-vs-forward check runs 2 prompts of
# 256 tokens on models and tokens from LM_CHECK_SEEDS seeds
LM_CHECK = (2, 256)
LM_CHECK_SEEDS = 3
# max |delta log-softmax| between teacher-forced decode and the forward in
# bf16: both round the residual stream to bf16, at other points (their
# matmuls split the sums differently, and the forward's attention output is
# rounded once per block).  Set at about twice this script's first reading
# (0.116 on an NVIDIA H100 80GB HBM3, 700 W, one seed); it prints the
# reading at each seed
LOGPROB_LIMIT = 0.25

# phase 6b: the MoE, MLA and Mamba families at full width, one card.  Each
# config's layers served in bf16 (the depth cut: phi3.5-moe and jamba take
# 83.7 and 103.1 GB at full depth; jamba's cut keeps whole periods of 8;
# deepseek-v2-lite and falcon-mamba, whole on the card, are cut to 9 of 27
# and 16 of 64 layers for the script's clock) and in the float32 check
# (under 60 GB of float32 weights: deepseek's dense prefix layer plus 8,
# jamba one period)
FAMILY_LAYERS = {
    "phi3.5-moe-42b-a6.6b": (16, 8),
    "deepseek-v2-lite-16b": (9, 9),
    "falcon-mamba-7b": (16, 16),
    "jamba-v0.1-52b": (16, 8),
}
# max |delta log-softmax| between teacher-forced decode and the forward in
# float32 (the capacity factor E / k, so the forward drops no token): both
# compute in float32, and differ by the order of their sums (the forward's
# blockwise attention and whole-sequence products against the kernel and
# one-row products).  Set at about twice the largest first reading
# (1.04e-4, falcon-mamba's 64 layers, on an NVIDIA H100 80GB HBM3, 700 W);
# it prints the reading of each family.  Even in float32 a router logit
# tie goes either way: from the first token the two paths route to other
# experts (phi3.5-moe's seed has one, at a margin of 5.7e-6), a row is not
# compared, and that token's margin must be under ROUTE_TIE, several times
# the most the two paths' router logits differ where they are compared
# (``router_logit_max_diff``, printed).
# The MoE families have no bf16 check of this kind: bf16 moves the router's
# input far more, and one flipped expert moves a token's logits by far more
# than LOGPROB_LIMIT
LOGPROB_LIMIT_F32 = 2e-4
ROUTE_TIE = 1e-4
# falcon-mamba's bf16 decode against its bf16 forward at 64 layers reads
# 0.4271 (NVIDIA H100 80GB HBM3, 700 W), over LOGPROB_LIMIT: the
# reference's forward rounds its causal conv tap by tap in bf16 where its
# decode step sums the taps in float32, and 64 layers add it up.  So the
# phase reads it and does not hold it; the float32 check holds the
# family's math, and each served token is held against a teacher-forced
# re-run

# phase 6c: whisper-medium (24 + 24 layers) and llava-next-mistral-7b (32)
# at full width and depth, one card.  llava's forward takes a full image
# prefix (16 tiles x 576 patches) and a LLAVA_PROMPT-token prompt; its
# float32 decode-vs-forward check runs the text-only backbone (an empty
# image prefix) at LLAVA_CHECK_LAYERS layers (7 GB of float32 layers).
# whisper's bf16 decode-vs-forward is held against LOGPROB_LIMIT: it read
# 0.0482 at 24 + 24 layers (8.6e-6 in float32; NVIDIA H100 80GB HBM3,
# 700 W)
LLAVA_PROMPT = 256
LLAVA_CHECK_LAYERS = 8

# phase 6d: the train step.  (a) train_lm's reference workload (the
# example's 200 steps, batch 8, 128 tokens; its loss must fall by more than
# 0.2); (b) llama3.2-3b at full width and depth in bf16 with float32
# masters and moments, TRAIN_FULL = (batch, tokens, steps) on one repeated
# batch from train_lm's stream; (c) one float32 step of llama3.2-3b at full
# width with TRAIN_CHECK_LAYERS layers, TRAIN_CHECK = (batch, tokens), on
# the card (TF32 off) against the same step on the CPU from the same
# masters: the loss, the gradient norm and each gradient leaf (relative to
# its norm) within TRAIN_CPU_LIMITS: about twice the first readings (loss
# 7.7e-8, gradient norm 0, worst leaf 4.26e-6, ``blocks.1.attn.wk``; NVIDIA
# H100 80GB HBM3, 700 W), two float32 ulps where the reading was 0
TRAIN_FULL = (2, 1024, 4)
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK = (2, 128)
TRAIN_CPU_LIMITS = {"loss": 1.6e-7, "grad_norm": 2.4e-7, "grad_leaf": 9e-6}
# phase 6e: the model dry run's cells held to the CPU sweep's counts, and
# the shard programs run for real against their predicted peak
MODEL_DRY_CELLS = (("llama3.2-3b", "train_4k"), ("llama3.2-3b", "decode_32k"),
                   ("phi3.5-moe-42b-a6.6b", "train_4k"),
                   ("deepseek-v2-lite-16b", "prefill_32k"),
                   ("falcon-mamba-7b", "long_500k"),
                   ("whisper-medium", "prefill_32k"),
                   ("llava-next-mistral-7b", "prefill_32k"))
MODEL_DRY_GOLDEN = "tests/golden/dryrun_models_pod.json"
MODEL_REAL_CELLS = (("llama3.2-3b", "train_4k"), ("llama3.2-3b", "prefill_32k"))
MODEL_PEAK_RTOL = 0.25
# phase 7: the quickstart's kernel hits at its SF 0.01 (the reference's,
# on the CPU) and the distributed example's row counts per query
QUICKSTART_HITS = {"filter": 10, "probe": 6, "agg": 9}
EXAMPLE_ROWS = {1: 4, 3: 10, 6: 1, 12: 2}


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


def device_ms(name: str, fn, iters: int = 20, warmup: int = 3) -> tuple:
    """The device time of kernel ``name``'s own grids per call of ``fn()``,
    in ms, and its grids per call: torch.profiler over the loop that
    ``cuda_ms`` times (the grids are those whose names DEVICE_NAMES lists)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiled loop has come back without the device's events after
    # several others in one process: such a loop is taken again, twice at
    # most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, grids = 0.0, 0
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and any(k in e.name for k in DEVICE_NAMES[name])):
                total += e.time_range.elapsed_us()
                grids += 1
        if grids:
            return total / iters / 1e3, grids / iters
    raise AssertionError(f"{name}: the profiler saw none of its grids")


def host_ms(fn, iters: int = 200, warmup: int = 3) -> float:
    """Host time of one call of ``fn()`` in ms: the host clock around
    ``iters`` calls that are not waited for (the device lags behind)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


L2_FLUSH_BYTES = 100 * 2**20     # twice the H100's 50 MB L2
SPIN_CYCLES = 200_000            # ~0.1 ms at the H100's 1.98 GHz


def evicted_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn()`` with the card's L2 evicted:
    before each call a 100 MB write, a read of the same 100 MB (so that L2
    holds clean lines, not dirty ones the call would have to write back)
    and a ~0.1 ms spin on the device, all outside the timed span (the spin
    lets the host enqueue the call before the device reaches it), then CUDA
    events around the call alone."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    spans = []
    for i in range(iters):
        flush.fill_(i)
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / iters


def kernel_times(name: str, fn) -> dict:
    """One wrapper call's ``ms`` (CUDA events around 20 calls: the host's
    checks, allocation and launch, or the device, whichever is slower),
    ``device_ms`` (the kernel's own grids alone) and ``host_ms``."""
    dev_ms, grids = device_ms(name, fn)
    return {"ms": cuda_ms(fn), "device_ms": dev_ms, "host_ms": host_ms(fn),
            "grids_per_call": grids}


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
        **kernel_times("filter_mask_counts",
                       lambda: ops.filter_mask_counts(x, lo_t, hi_t)),
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
    got = ops.groupby_sum_large(gi, va, g)
    torch.cuda.synchronize()
    # the plain version sums in float64 and rounds once, as the kernel does
    want = ref.groupby_sum_ref(gi, va, g)
    # sum|v| per (group, column), over the rows the call keeps
    keep = (gi >= 0) & (gi < g)
    scale = torch.zeros((g, v), dtype=torch.float64, device=dev).index_add_(
        0, torch.where(keep, gi, 0).long(), va.double().abs() * keep[:, None])
    err = (got.double() - want.double()).abs()
    # the counts (column 0) are exact in float32 below 2^24 rows a group;
    # on the other columns the two float64 sums, taken in other orders,
    # round to float32 within an ulp of each other (1.2e-7 x |sum|), while
    # one dropped row of a 2 M-row group is about 5e-7 x sum|v|
    if not torch.equal(got[:, 0], want[:, 0]):
        raise AssertionError(f"groupby_sum ({what}): the count column is not "
                             f"exact")
    rel = (err[:, 1:] / scale[:, 1:].clamp(min=1e-300)).max()
    gl_kept, va_kept = gi[keep].long(), va[keep]
    if not bool((err[:, 1:] <= 2e-7 * scale[:, 1:]).all()):
        raise AssertionError(f"groupby_sum ({what}): error {float(rel):.3g} "
                             f"x sum|v| exceeds 2e-7")
    return {
        "name": "groupby_sum", "shape": f"N={n}, V={v}, G={g} ({what})",
        "max_abs_err": float(err.max()),
        "max_err_over_sum_abs": float(rel),
        "tolerance": "column 0 (counts) exact; the others 2e-7 x sum|v| per "
                     "(group, column)",
        **kernel_times("groupby_sum", lambda: ops.groupby_sum_large(gi, va, g)),
        "plain_ms": cuda_ms(lambda: ref.groupby_sum_ref(gi, va, g)),
        # index_add_ takes only gids in range: timed on the rows the call keeps
        "library_ms": cuda_ms(lambda: torch.zeros(
            (g, v), dtype=torch.float32, device=dev).index_add_(0, gl_kept, va_kept)),
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
    2,000,000 rows, where every row falls in one group (q0, q1, q20 and q43x
    call it with one group too), Q3's call at SF1 (11,932 groups, called
    with G rounded up to 16,384) and Q13's inner group-by at SF10
    (15,321,151 rows over 1,500,000 customers, G = 2^21), both above 4096
    groups and so one-pass, go under ``other_shapes``, and so does one
    chunk of ClickBench q32 at 99,997,497 rows (2^24 rows, the chunk
    core/kernel_backend.py takes past ROW_BOUND, over nearly 100 M
    (WatchID, ClientIP) groups, G = 2^27).  Each is called through
    ``groupby_sum_large``, as core/kernel_backend.py calls it, so that
    ``kernel_turns.py`` times a checkout that cut G above 4096 into
    4096-group calls on the same inputs."""
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
    # Q3: count and sum(revenue) of 31,617 rows over 11,932 groups
    n = 31_617
    vals = np.empty((n, 3), np.float32)
    vals[:, 0] = 1.0
    _centred_split(vals, 1, rng.uniform(900, 105_000, n))
    q3 = _groupby_case(rng.integers(0, 11_932, n).astype(np.int32), vals,
                       16_384, "Q3 at SF1, 11,932 live groups", dev)
    # Q13: count(*) and count(o_orderkey) of the customer-orders outer join
    # at SF10 (one row per order, plus one per customer without orders),
    # by customer
    n = 15_321_151
    vals = np.empty((n, 3), np.float32)
    vals[:, 0] = 1.0
    _centred_split(vals, 1, (rng.random(n) < 0.98).astype(np.float64))
    q13 = _groupby_case(rng.integers(0, 1_500_000, n).astype(np.int32), vals,
                        2 ** 21, "Q13 at SF10, 1,500,000 live groups", dev)
    # q32: count(*), sum(IsRefresh) and avg(ResolutionWidth) by (WatchID,
    # ClientIP), one 2^24-row chunk of the 99,997,497 rows; nearly every
    # row is a group of its own
    n = 2 ** 24
    vals = np.empty((n, 5), np.float32)
    vals[:, 0] = 1.0
    _centred_split(vals, 1, (rng.random(n) < 0.1).astype(np.float64))
    _centred_split(vals, 3, rng.choice(widths, n).astype(np.float64))
    q32 = _groupby_case(rng.integers(0, 99_997_497, n).astype(np.int32), vals,
                        2 ** 27, "ClickBench q32, one 2^24-row chunk of "
                        "99,997,497 rows", dev)
    return {**q1, "other_shapes": [q2, q3, q13, q32]}


def _probe_rounds(keys, slots_key, slots_row, max_probes: int = 32) -> float:
    """Mean probe rounds these keys take: each chain read up to its hit, its
    empty slot or max_probes rounds (for the operation count)."""
    import torch
    from repro_torch.kernels.ref import hash32
    cap = slots_row.shape[0]
    h0 = hash32(keys, cap - 1).long()
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    steps = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    for i in range(max_probes):
        steps += (~done).long()
        cand = (h0 + i) & (cap - 1)
        r = slots_row[cand]
        done |= (r == -1) | ((r >= 0) & (slots_key[cand] == keys))
    return float(steps.double().mean())


# hash_probe's shapes on the main paths at SF1, as phase 4 records each
# call (keys, build rows, hit share): Q3's second call (lineitem into the
# orders that pass: 31,617 hits; the keys that miss are all the absent rank
# -2) and Q5's third (orders into the customers of the region; every key
# hits)
PROBE_Q3 = (3_049_330, 154_674, 31_617 / 3_049_330)
PROBE_Q5 = (242_080, 150_000, 1.0)


def _probe_table(rng, n_build: int, dev):
    """try_probe's build of ``n_build`` distinct int64 keys from 0..6 M:
    sorted_build's ranks into build_table32 → (keys, sorted keys, slots)."""
    import torch
    from repro_torch.kernels import ops
    build_keys = rng.choice(6_000_000, n_build, replace=False).astype(np.int64)
    bk = torch.from_numpy(build_keys).to(dev)
    nb = ops.bucket_size(n_build)
    valid = torch.arange(nb, device=dev) < n_build
    s, _, ranks, dup, _ = ops.sorted_build(ops.pad_rows(bk, nb), valid)
    sk, sr, placed = ops.build_table32(
        torch.where(valid, ranks, -1).to(torch.int32), valid)
    if bool(dup) or not bool(placed):
        raise AssertionError("hash_probe: synthetic build is not unique/placed")
    return build_keys, s, sk, sr


def _probe_case(p32, sk, sr, what: str) -> dict:
    """hash_probe on these keys against the plain version, exactly, and its
    times: warm (``kernel_times``) and with L2 evicted (``evicted_ms``)."""
    import torch
    from repro_torch.kernels import ops, ref
    row, found = ops.hash_probe(p32, sk, sr)
    torch.cuda.synchronize()
    want_row, want_found = ref.hash_probe_ref(p32, sk, sr)
    bad = int((row != want_row).sum()) + int((found != want_found).sum())
    if bad:
        raise AssertionError(f"hash_probe ({what}): {bad} entries differ from "
                             f"the plain version")
    n, cap = p32.shape[0], sk.shape[0]
    rounds = _probe_rounds(p32, sk, sr)
    return {
        "name": "hash_probe",
        "shape": f"N={n} keys, build {int((sr >= 0).sum())} rows, "
                 f"capacity {cap} ({what})",
        "hit_share": float(found.double().mean()),
        "max_abs_err": 0.0, "tolerance": "exact",
        "mean_probe_rounds": rounds,
        **kernel_times("hash_probe", lambda: ops.hash_probe(p32, sk, sr)),
        "evicted_ms": evicted_ms(lambda: ops.hash_probe(p32, sk, sr)),
        "plain_ms": cuda_ms(lambda: ref.hash_probe_ref(p32, sk, sr), iters=5),
        "library_ms": None,
        **bound(n * 4 + cap * 8 + n * 5, n * (4 + 3 * rounds)),
    }


def check_probe(rng, dev) -> dict:
    """The row is (a), Q3's second call as the main path makes it at SF1
    (PROBE_Q3: ~1% hits, every other key the absent rank -2); (b), 3,049,330
    keys into the same build size with 20% drawn from the build keys and
    the rest from 0..6 M, and (c), Q5's third call (PROBE_Q5: every key
    hits), go under ``other_shapes``."""
    import torch
    from repro_torch.kernels import ops
    n_probe, n_build, share = PROBE_Q3
    # (b) first, so that its inputs stay those of earlier runs
    build_keys, s, sk, sr = _probe_table(rng, n_build, dev)
    hit = rng.random(n_probe) < 0.2
    probe_keys = np.where(hit, rng.choice(build_keys, n_probe),
                          rng.integers(0, 6_000_000, n_probe)).astype(np.int64)
    p32 = ops.map_probe_keys(s, torch.from_numpy(probe_keys).to(dev))
    mixed = _probe_case(p32, sk, sr, "20% drawn from the build keys")
    cases = {}
    for what, (n_probe, n_build, share) in (
            ("Q3's second call", PROBE_Q3), ("Q5's third call", PROBE_Q5)):
        build_keys, s, sk, sr = _probe_table(rng, n_build, dev)
        # keys that miss lie past the build's range: map_probe_keys makes
        # each of them -2
        probe_keys = np.where(rng.random(n_probe) < share,
                              rng.choice(build_keys, n_probe),
                              6_000_000 + rng.integers(0, 6_000_000, n_probe))
        p32 = ops.map_probe_keys(s, torch.from_numpy(probe_keys).to(dev))
        cases[what] = _probe_case(p32, sk, sr, what)
    return {**cases["Q3's second call"],
            "other_shapes": [mixed, cases["Q5's third call"]]}


def _expand_case(order, lo, counts, what: str) -> dict:
    """join_expand of an inner join's runs against its plain version over
    the whole bucket, filler included."""
    import torch
    from repro_torch.kernels import ops, ref
    n, nb = lo.shape[0], order.shape[0]
    total = int(counts.sum())
    t_pad = ops.bucket_size(total)
    got = ops.join_expand(order, lo, counts, counts, t_pad)
    torch.cuda.synchronize()
    want = ref.join_expand_ref(order, lo, counts, counts, t_pad)
    bad = sum(int((a != b).sum()) for a, b in zip(got, want))
    if bad:
        raise AssertionError(f"join_expand ({what}): {bad} entries differ "
                             f"from the plain version over the {t_pad} bucket")
    return {
        "name": "join_expand",
        "shape": f"{n} runs, {nb} build rows, {total} outputs "
                 f"in a {t_pad} bucket ({what})",
        "max_abs_err": 0.0,
        "tolerance": "exact over the whole bucket, filler included",
        **kernel_times("join_expand",
                       lambda: ops.join_expand(order, lo, counts, counts, t_pad)),
        "plain_ms": cuda_ms(lambda: ref.join_expand_ref(order, lo, counts,
                                                         counts, t_pad)),
        "library_ms": None,
        # counts_out read once, the three outputs written
        # over the bucket, and lo, counts and order gathered once per output
        **bound(n * 8 + t_pad * 17 + total * 3 * 8,
                t_pad * 2 * n.bit_length()),
    }


def _join_runs(pk: np.ndarray, bk: np.ndarray, dev):
    import torch
    from repro_torch.relational.join import join_match
    return join_match(torch.from_numpy(pk).to(dev), torch.from_numpy(bk).to(dev))


def check_expand(rng, dev) -> dict:
    """Q5 calls join_expand twice at SF1; the larger call is the row's
    numbers, the smaller and a skewed case (one run of 300,000 among
    1,000,000 empty runs: one block writes it all) go under
    ``other_shapes``."""
    import torch
    # lineitem ⋈ orders, which try_probe declines (its build of the 1994
    # orders is too large for build_table32): lineitem's orderkeys, sorted as
    # the table is, into ~227,000 distinct orderkeys of 1.5 M orders
    n_orders = 1_500_000
    pk = np.sort(rng.integers(0, n_orders, 5_996_021))
    bk = np.sort(rng.choice(n_orders, 227_000, replace=False)).astype(np.int64)
    large = _expand_case(*_join_runs(pk, bk, dev), "Q5 lineitem x orders")
    # the two-key join on (l_suppkey, c_nationkey), combined into one key
    domain = 50_000
    bk = rng.choice(domain, 2_003, replace=False).astype(np.int64)
    pk = rng.integers(0, domain, 968_874)
    small = _expand_case(*_join_runs(pk, bk, dev),
                         "Q5 (l_suppkey, c_nationkey) join")
    n, long_run, at = 1_000_000, 300_000, 654_321
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    counts[at] = long_run
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    order = torch.from_numpy(rng.permutation(long_run)).to(dev)
    skew = _expand_case(order, lo, counts, "skew: one run of 300,000")
    return {**large, "other_shapes": [small, skew]}


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
        **kernel_times("topk_select", lambda: ops.topk_select(keys, k)),
        "plain_ms": cuda_ms(lambda: ref.topk_select_ref(keys, k)),
        # its tie order is unspecified: timed, not held
        "library_ms": cuda_ms(lambda: torch.topk(keys, k, largest=False)),
        **bound(n * keys.element_size() + k * 4, n),
    }


def check_topk(rng, dev) -> dict:
    """The row is q21's and q22's main-path call at 2,000,000 rows (433
    groups, LIMIT 10; keys are try_topk's composites of a descending count
    and a dictionary code); the 2^20-key call with heavy ties, q14's call
    at 2,000,000 rows (1,732 groups, a composite of a descending count, the
    engine id and the phrase code that spans more than 2^24, so int64) and
    an int64 call at the size of the ClickBench cell's per-user top 10
    (17,630,976 ranks, heavy ties, negative keys and both ends of int64) go
    under ``other_shapes``."""
    n = 433
    counts = rng.integers(1, 20_000, n)
    codes = rng.permutation(n)
    keys = ((counts.max() - counts) * n + codes).astype(np.float32)
    main = _topk_case(keys, 10, "q21/q22 at 2 M rows", dev)
    n = 1_048_573                       # not a multiple of the 1024-key tile
    ties = rng.integers(0, 1000, n).astype(np.float32)
    large = _topk_case(ties, 128, "integers 0..999, heavy ties", dev)
    n, engines, phrases = 1_732, 42, 434
    counts = rng.integers(1, 112_000, n)
    pairs = rng.choice(engines * phrases, n, replace=False)
    keys = (counts.max() - counts) * (engines * phrases) + pairs
    q14 = _topk_case(keys.astype(np.int64), 10,
                     "q14 at 2 M rows, int64 composite", dev)
    n = 17_630_976
    values = np.concatenate([
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]),
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 996)])
    wide = _topk_case(rng.choice(values, n), 10,
                      "int64, 1,000 values over the whole range, heavy ties",
                      dev)
    return {**main, "other_shapes": [large, q14, wide]}


def _count_distinct_case(gids_np: np.ndarray, values_np: np.ndarray, g: int,
                         what: str, dev) -> dict:
    import torch
    from repro_torch.kernels import count_distinct as cd
    from repro_torch.kernels import ops, ref
    gids = torch.from_numpy(gids_np).to(dev)
    values = torch.from_numpy(values_np).to(dev)
    got = ops.count_distinct(gids, values, g)
    torch.cuda.synchronize()
    want = ref.count_distinct_ref(gids, values, g)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"count_distinct ({what}): {bad} of {g} counts "
                             f"differ from the plain version")
    n = gids.shape[0]
    pairs = (values if g == 1 else
             torch.stack([gids.to(torch.int64), values], 1))
    slots = cd.table_slots(n)
    row = {
        "name": "count_distinct", "shape": f"N={n}, G={g} ({what})",
        "distinct_pairs": int(want.sum()),
        "max_abs_err": 0.0, "tolerance": "exact (counts)",
        **kernel_times("count_distinct",
                       lambda: ops.count_distinct(gids, values, g)),
        "plain_ms": cuda_ms(lambda: ref.count_distinct_ref(gids, values, g)),
        # the same pairs made unique by one library call (the counting by
        # group left out)
        "library_ms": cuda_ms(lambda: torch.unique(pairs, dim=0)),
        # what the function must move: each row's gid and value read, the
        # counts written
        **bound(n * (8 + 4) + g * 8, n),
        # what the design adds: the wrapper's fill of the table (outside
        # device_ms, which reads the kernel's grid; inside ms), its floor
        # at the card's bandwidth, and one random slot access a row
        "table_bytes": slots * cd.SLOT_BYTES,
        "table_fill_bound_ms": slots * cd.SLOT_BYTES / HBM_BYTES_PER_S * 1e3,
        "table_fill_ms": cuda_ms(lambda: torch.full(
            (slots * cd.SLOT_BYTES // 8,), -1, dtype=torch.int64, device=dev)),
    }
    del gids, values, pairs, got, want
    torch.cuda.empty_cache()
    return row


def _users(rng, n: int, users: int, skew: float) -> np.ndarray:
    """Row -> user of ``n`` rows over ``users`` users, each on a row at
    least once, the rest zipf-skewed by ``skew`` (benchmark's generator's
    law: P(r) about (r + 1)^-skew)."""
    u = rng.random(n - users)
    x = ((users ** (1 - skew) - 1) * u + 1) ** (1 / (1 - skew))
    rank = np.clip(np.floor(x).astype(np.int64) - 1, 0, users - 1)
    return rng.permutation(np.concatenate([np.arange(users), rank]))


def _regions(rng, users: int) -> tuple:
    """Each user's home region, one of 229 skewed at 0.7, as dense gids
    from 0 over the regions some user has → (gid per user, regions)."""
    u = rng.random(users)
    region = np.clip(np.floor(((229 ** 0.3 - 1) * u + 1) ** (1 / 0.3))
                     .astype(np.int64) - 1, 0, 228)
    present = np.unique(region)
    return np.searchsorted(present, region).astype(np.int32), present.size


def _q4_q9_calls(rng, n: int, users: int, dev) -> list:
    """ClickBench q4's call (count(distinct UserID), one group) and q9's
    (the same users by RegionID) over ``n`` rows of ``users`` users,
    63-bit ids, zipf-skewed at the benchmark generator's 0.9."""
    ids = rng.integers(0, 2 ** 63 - 1, users, dtype=np.int64)
    user = _users(rng, n, users, 0.9)
    values = ids[user]
    del ids
    rows = "2^24 rows" if n == 2 ** 24 else f"{n:,} rows"
    q4 = _count_distinct_case(np.zeros(n, np.int32), values, 1,
                              f"q4: UserID, one group, {rows}", dev)
    region, g = _regions(rng, users)
    q9 = _count_distinct_case(region[user], values, g,
                              f"q9: UserID by RegionID, {rows}", dev)
    return [q4, q9]


def check_count_distinct(rng, dev) -> dict:
    """The row is a 2^24-row cut of ClickBench q4's call: 2,958,060 users,
    the cell's 17,630,976 a 99,997,497 rows scaled down.  Under
    ``other_shapes``: q9's call at the same cut, then q4's and q9's calls
    as ``clickbench-hits.hot`` makes them, over 99,997,497 rows of
    17,630,976 users (a 2^28-slot, 4.3 GB table: byte offsets past 2^32)."""
    n = 2 ** 24
    q4, q9 = _q4_q9_calls(rng, n, 17_630_976 * n // 99_997_497, dev)
    full = _q4_q9_calls(rng, 99_997_497, 17_630_976, dev)
    return {**q4, "other_shapes": [q9, *full]}


def _decode_bf16_scores(q, k, v, n):
    """A control: the plain version with its scores rounded to bf16."""
    import torch
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / (d ** 0.5)
    sc = sc.to(torch.bfloat16).float()
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    sc = torch.where(pos < n[:, None, None, None], sc, -1e30)
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(sc, -1), v.float())
    return out.reshape(b, h, d).to(q.dtype)


def _decode_case(b: int, h: int, kvh: int, d: int, s: int, lengths,
                 dtype: str, what: str, rng, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    tdt = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, tdt)

    q, k, v = draw(b, h, d), draw(b, s, kvh, d), draw(b, s, kvh, d)
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = ops.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, k, v, n)
    tol = 2e-5 if dtype == "float32" else 3e-2
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"decode_attention ({what}): max abs error "
                             f"{err:.3g} exceeds {tol} (rtol and atol)")
    tight = {}
    if dtype == "bfloat16":
        exact = ref.decode_attention_ref(q.float(), k.float(), v.float(), n)
        limit = BF16_HALF_ULP * exact.abs() + F32_NOISE

        def ratio(x):      # the largest |x - exact| over its limit
            return float(((x.float() - exact).abs() / limit).max())

        dropped = torch.where(n >= 2, n.clamp(max=s) - 1, n)
        tight = {"decode_limit_ratio": ratio(got),
                 "control_bf16_scores_ratio": ratio(_decode_bf16_scores(q, k, v, n)),
                 "control_last_row_dropped_ratio": ratio(
                     ref.decode_attention_ref(q, k, v, dropped))}
        if not tight["decode_limit_ratio"] <= 1.0:
            raise AssertionError(
                f"decode_attention ({what}): {tight['decode_limit_ratio']:.3g} "
                f"times half a bf16 ulp + {F32_NOISE} off the float32 value")
        if not tight["control_last_row_dropped_ratio"] > 1.0:
            raise AssertionError(f"decode_attention ({what}): the limit does "
                                 f"not catch a dropped row")
    # the library yardstick: SDPA over k and v laid out (B, KVH, S, D) in
    # advance, a boolean mask per row; rows with lengths <= 0 (all masked)
    # have no SDPA counterpart and are left out of its check
    q4, kl, vl = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=dev)[None, :] < n[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask,
                                              enable_gqa=True)

    lib = sdpa()[:, :, 0]
    live = n > 0
    lib_err = float((lib[live].float() - want[live].float()).abs().max())
    if not torch.allclose(lib[live].float(), want[live].float(), rtol=tol, atol=tol):
        raise AssertionError(f"decode_attention ({what}): SDPA is {lib_err:.3g} "
                             f"off the plain version")
    if tight:
        tight["sdpa_limit_ratio"] = float(
            ((lib[live].float() - exact[live]).abs() / limit[live]).max())
    itemsize = q.element_size()
    rows = [min(x, s) if x > 0 else s for x in lengths]
    kv_rows = sum(r if x > 0 else 0 for r, x in zip(rows, lengths))
    # each valid k and v row read once (only v where lengths <= 0: the
    # uniform mean), q read and the output written once, and the lengths
    nbytes = (kv_rows + sum(rows)) * kvh * d * itemsize + 2 * q.numel() * itemsize + 4 * b
    ops_ = 4 * d * (h // kvh) * kvh * sum(rows)   # q.k and p.v, 2 flops each
    return {
        "name": "decode_attention",
        "shape": f"q ({b},{h},{d}) {dtype}, cache ({b},{s},{kvh},{d}), "
                 f"lengths {list(lengths) if b <= 8 else '...'} ({what})",
        "max_abs_err": err, "tolerance": f"{tol} (rtol and atol)",
        **tight, "sdpa_max_abs_err": lib_err,
        **kernel_times("decode_attention",
                       lambda: ops.decode_attention(q, k, v, n)),
        "plain_ms": cuda_ms(lambda: ref.decode_attention_ref(q, k, v, n)),
        "library_ms": cuda_ms(sdpa),
        "library": "torch.nn.functional.scaled_dot_product_attention(bool "
                   "mask, enable_gqa=True) on k and v laid out (B,KVH,S,D) "
                   "in advance",
        **bound(nbytes, ops_),
    }


def check_decode_attention(rng, dev) -> dict:
    """The row is the server's call (phase 6: batch 8, llama3.2-3b's 24
    query and 8 KV heads of 128, an 8192-row bf16 cache, ragged lengths in
    64-576); decode_32k's 32,768-row cache, a float32 group-7 case with
    length 0, batch 1 over a full 32,768-row cache (the fewest (row, KV
    head) units, so the most splits), phase 6b's call of phi3.5-moe and
    jamba (32 query and 8 KV heads: group 4, the largest a block takes
    whole) and phase 6c's call of whisper-medium (16 query and 16 KV heads
    of 64: group 1) go under ``other_shapes``."""
    lengths = [int(x) for x in rng.integers(64, 577, 8)]
    main = _decode_case(8, 24, 8, 128, 8192, lengths, "bfloat16",
                        "the server's batch", rng, dev)
    long = _decode_case(4, 24, 8, 128, 32768, [32768, 32769, 1, 20000],
                        "bfloat16", "decode_32k's cache", rng, dev)
    f32 = _decode_case(4, 28, 4, 64, 1536, [0, 1, 1000, 1537], "float32",
                       "float32, group 7, D=64", rng, dev)
    one = _decode_case(1, 24, 8, 128, 32768, [32768], "bfloat16",
                       "batch 1, a full 32,768-row cache", rng, dev)
    group4 = _decode_case(8, 32, 8, 128, 8192,
                          [int(x) for x in rng.integers(64, 577, 8)],
                          "bfloat16", "phi3.5-moe's and jamba's call, group 4",
                          rng, dev)
    whisper = _decode_case(8, 16, 16, 64, 8192,
                           [int(x) for x in rng.integers(64, 577, 8)],
                           "bfloat16", "whisper-medium's decoder "
                           "self-attention, group 1, D=64", rng, dev)
    return {**main, "other_shapes": [long, f32, one, group4, whisper]}


# phase 3's checks, in order; each runs in a process of its own
PHASE3 = ("check_filter", "check_groupby", "check_probe", "check_expand",
          "check_topk", "check_decode_attention", "check_count_distinct")
CHECK_CHILD = """
import json, sys
import numpy as np, torch
sys.path.insert(0, {root!r})
import chip_smoke
check = getattr(chip_smoke, {check!r})
print(json.dumps(check(np.random.default_rng(chip_smoke.SEED),
                       torch.device("cuda", 0))), flush=True)
"""


def run_check(check: str, src: Path = ROOT / "src") -> dict:
    """Run phase-3 check ``check`` of this script, on inputs from SEED, in a
    process of its own that imports ``repro_torch`` from ``src``, and return
    its row: torch.profiler, which ``device_ms`` uses, has come back without
    a kernel's events after some 16 profiled loops in one process."""
    env = dict(os.environ, PYTHONPATH=str(src))
    if Path(src).resolve() != (ROOT / "src").resolve():
        env.pop("REPRO_TORCH_BUILD_DIR", None)   # another checkout builds its own
    out = subprocess.run(
        [sys.executable, "-c", CHECK_CHILD.format(root=str(ROOT), check=check)],
        env=env, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{check} ({src}) failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.splitlines()[-1])


# ---------------------------------------------------------------------------
# phase 4: the TPC-H path
# ---------------------------------------------------------------------------


def compare_tables(got: dict, want: dict, rtol: float = 1e-6):
    """Row-exact for non-float columns, ``rtol`` (atol 1e-6) for floats
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
                                       rtol=rtol, atol=1e-6, err_msg=k)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
            if rel.size and float(rel.max()) >= worst:
                worst, worst_col = float(rel.max()), k
        elif not (a == b).all():
            raise AssertionError(f"column {k}: {a[:5]} vs {b[:5]}")
    return worst, worst_col


def _kernel_calls(fn) -> tuple:
    """Run ``fn()`` and return the shapes of the ``groupby_sum`` calls
    ((N, V, G) each; groupby_sum_large calls the wrapper through ``ops``)
    and of the ``hash_probe`` calls it makes: keys, build rows, slots, hits,
    the share of the most common key and the mean probe rounds."""
    import torch
    from repro_torch.kernels import ops
    agg, probe = [], []
    groupby_sum, hash_probe = ops.groupby_sum, ops.hash_probe

    def record_agg(gids, values, n_groups):
        agg.append(list(values.shape) + [int(n_groups)])
        return groupby_sum(gids, values, n_groups)

    def record_probe(keys, slots_key, slots_row, *args, **kwargs):
        row, found = hash_probe(keys, slots_key, slots_row, *args, **kwargs)
        n = keys.shape[0]
        top = int(torch.unique(keys, return_counts=True)[1].max()) if n else 0
        probe.append({"keys": n, "build_rows": int((slots_row >= 0).sum()),
                      "slots": slots_row.shape[0], "hits": int(found.sum()),
                      "top_key_share": top / max(n, 1),
                      "mean_probe_rounds": _probe_rounds(keys, slots_key,
                                                         slots_row)})
        return row, found

    ops.groupby_sum, ops.hash_probe = record_agg, record_probe
    try:
        fn()
    finally:
        ops.groupby_sum, ops.hash_probe = groupby_sum, hash_probe
    return agg, probe


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
    # phase 4 measures the uncached (eager) path; phase 4b the default one
    eng = SiriusEngine(use_kernels=True, compile_pipelines=False)
    load_into_engine(eng, db)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    plain = SiriusEngine(use_kernels=False, compile_pipelines=False)
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
        agg_calls, probe_calls = _kernel_calls(
            lambda: prof.execute(QUERIES[qid]()))
        op_times = dict(prof.executor.op_times)
        ref_out, plain_cold = timed(plain, qid)
        plain_warm = statistics.median(timed(plain, qid)[1] for _ in range(3))
        err, err_col = compare_tables(results[qid]["out"], ref_out.to_host())
        row = {"query": f"Q{qid}", "rows": len(next(iter(ref_out.to_host().values()))),
               "hits": results[qid]["hits"], "launches": results[qid]["launches"],
               "profiled_op_seconds": op_times, "groupby_sum_calls": agg_calls,
               "hash_probe_calls": probe_calls,
               "cold_s": results[qid]["cold_s"], "warm_s": results[qid]["warm_s"],
               "plain_engine_cold_s": plain_cold, "plain_engine_warm_s": plain_warm,
               "max_rel_err": err, "max_rel_err_column": err_col}
        emit({"phase": "query", **row})
        per_query.append(row)
    tables = {name: eng.buffers.get(name) for name in db}
    return {"launches": launches, "queries": per_query,
            "generate_s": t_gen, "load_s": t_load}, tables, db


# ---------------------------------------------------------------------------
# phase 4b: the default path (fused regions, plan cache, CUDA graph replays)
# ---------------------------------------------------------------------------


def run_compiled_path(tables: dict) -> dict:
    """All 22 TPC-H queries at SF1 on the tables phase 4 loaded (registered
    again: the same device tensors), on three engines: the default path with
    the kernels (``use_kernels=True``: the closure loop replays), the
    default path without them (``SiriusEngine()``: warm runs replay one
    CUDA graph) and the eager ``compile_pipelines=False`` engine as the
    yardstick.  Hand-built plans cold once and warm ``WARM_RUNS`` times,
    each result held against the yardstick's; then the 22 SQL texts
    through ``eng.sql``, whose second call must skip the parser."""
    import torch
    from repro_torch import sql as port_sql
    from repro_torch.core import instrument
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.data.tpch_queries import QUERIES, SQL_QUERIES
    from repro_torch.kernels import build

    def engine(**kw):
        e = SiriusEngine(**kw)
        for name, t in tables.items():
            e.register(name, t)
        return e

    yard = engine(use_kernels=False, compile_pipelines=False)
    engines = {"kernels": engine(use_kernels=True),
               "graph": engine(use_kernels=False)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()

    def timed(e, qid):
        t = time.perf_counter()
        out = e.execute(QUERIES[qid]())
        return out, time.perf_counter() - t

    def warm_run(e, qid):
        syncs = instrument.scalar_syncs.value
        barriers = instrument.sync_barriers.value
        out, s = timed(e, qid)
        ex = e.executor
        if not ex.last_plan_cache_hit:
            raise AssertionError(f"Q{qid}: a warm run missed the plan cache")
        got = (instrument.scalar_syncs.value - syncs,
               instrument.sync_barriers.value - barriers)
        if got != (0, 1):
            raise AssertionError(f"Q{qid}: a warm run took {got[0]} scalar "
                                 f"syncs and {got[1]} barriers, not 0 and 1")
        return out, s, ex.last_replay_mode

    build.reset_launch_counts()
    rows = []
    for qid in sorted(QUERIES):
        want, yard_cold = timed(yard, qid)
        want = want.to_host()
        yard_warm = statistics.median(timed(yard, qid)[1]
                                      for _ in range(WARM_RUNS))
        row = {"query": f"Q{qid}", "rows": len(next(iter(want.values()))),
               "eager_cold_s": yard_cold, "eager_warm_s": yard_warm}
        for label, e in engines.items():
            launched = build.launch_counts()
            before = e.backend.hit_counts() if e.backend else None
            out, cold = timed(e, qid)
            if before is not None:
                after = e.backend.hit_counts()
                hits = {k: after[k] - before[k] for k in after}
            err, _ = compare_tables(out.to_host(), want)
            warms, modes = [], set()
            for _ in range(WARM_RUNS):
                out, s, mode = warm_run(e, qid)
                compare_tables(out.to_host(), want)
                warms.append(s)
                modes.add(mode)
            with instrument.track_transfers() as counter:
                warm_run(e, qid)
            if counter.in_pipeline:
                raise AssertionError(f"Q{qid} ({label}): {counter.in_pipeline}"
                                     f" device-to-host copies in pipelines")
            (mode,) = modes
            row[label] = {"cold_s": cold, "warm_s": statistics.median(warms),
                          "replay": mode, "max_rel_err": err,
                          "launches": {k: n - launched[k] for k, n in
                                       build.launch_counts().items()
                                       if n - launched[k]}}
            if before is not None:
                row[label]["hits"] = hits   # the cold run's
        hits = row["kernels"]["hits"]
        if hits != EXPECTED_HITS_SF1[qid]:
            raise AssertionError(f"Q{qid}: kernel hits {hits}, expected "
                                 f"{EXPECTED_HITS_SF1[qid]}")
        for label in engines:
            want_mode = ("graph" if label == "graph" and qid in
                         EXPECTED_GRAPH_QIDS else "closure")
            if row[label]["replay"] != want_mode:
                err = engines[label].executor.capture_errors
                raise AssertionError(
                    f"Q{qid} ({label}): replayed by {row[label]['replay']}, "
                    f"expected {want_mode}; capture errors: {err}")
        emit({"phase": "compiled_query", **row})
        rows.append(row)
    launches = build.launch_counts()
    missing = [k for k in PATH_KERNELS["tpch"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the compiled TPC-H "
                             f"path: {missing}")

    # SQL text: the second call of each query skips lexer, parser, binder
    # and optimizer and replays the entry the first call recorded
    parses = []
    run_sql = port_sql.run_sql

    def counting_run_sql(*args, **kwargs):
        parses.append(1)
        return run_sql(*args, **kwargs)

    # the kernel engine's first call of each text: its kernel hits and plan
    # signature, which phase 5b holds the front door's cold runs against
    sql_runs = {}
    port_sql.run_sql = counting_run_sql
    try:
        for qid in sorted(SQL_QUERIES):
            want = yard.execute(QUERIES[qid]()).to_host()
            for label, e in engines.items():
                n0 = len(parses)
                before = e.backend.hit_counts() if e.backend else None
                compare_tables(e.sql(SQL_QUERIES[qid]).to_host(), want)
                if before is not None:
                    after = e.backend.hit_counts()
                    sql_runs[qid] = {
                        "hits": {k: after[k] - before[k] for k in after},
                        "signature": e.executor.last_plan_signature,
                        "cold": not e.executor.last_plan_cache_hit}
                compare_tables(e.sql(SQL_QUERIES[qid]).to_host(), want)
                if len(parses) - n0 != 1 or not e.executor.last_plan_cache_hit:
                    raise AssertionError(f"SQL Q{qid} ({label}): the second "
                                         f"call did not take the text cache")
    finally:
        port_sql.run_sql = run_sql

    # what the graph engine's entries hold: the device memory that
    # dropping them gives back (their graphs' pool, the build tables their
    # fused probes captured, the results their replays skip), with the
    # allocator's free cached blocks released on both sides
    graph_ex = engines["graph"].executor
    torch.cuda.synchronize()
    reserved1 = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    entries = len(graph_ex.plan_cache)
    graph_ex.plan_cache.clear()
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved2 = torch.cuda.memory_reserved()
    memory = {"reserved_before_bytes": reserved0,
              "reserved_after_bytes": reserved1,
              "graph_engine_entries": entries,
              "graph_engine_entries_bytes": held - reserved2,
              "capture_failures": graph_ex.capture_failures,
              "capture_errors": graph_ex.capture_errors}
    emit({"phase": "compiled_memory", **memory})
    return {"launches": launches, "queries": rows, "memory": memory,
            "sql_runs": sql_runs}


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
    eng = SiriusEngine(use_kernels=True, compile_pipelines=False)
    cb.load_into_engine(eng, db)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    hits_table = eng.buffers.get("hits")
    plain = SiriusEngine(use_kernels=False, compile_pipelines=False)
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
        want = _cb_hits(qid)
        if hits != want:
            raise AssertionError(f"ClickBench {qid}: kernel hits {hits}, "
                                 f"expected at {CB_ROWS} rows {want}")
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
            "generate_s": t_gen, "load_s": t_load}, hits_table, db


# ---------------------------------------------------------------------------
# phase 5b: the drop-in front door (Substrait wire plans through accelerate)
# ---------------------------------------------------------------------------


def _golden_wire(name: str) -> bytes:
    return (ROOT / "tests" / "golden" / "substrait" / f"{name}.json").read_bytes()


def _hybrid_plans():
    """The reference tests' hybrid plans (``tests/test_substrait.py``):
    name → (plan builder, registry, placements, deps, boundary bytes that
    must be positive: to host, to device)."""
    from repro_torch.core.plan import (AggregateRel, FilterRel, ReadRel,
                                       SetRel, WindowRel)
    from repro_torch.data.tpch_queries import SQL_QUERIES
    from repro_torch.relational.aggregate import AggSpec
    from repro_torch.relational.expressions import BinOp, Col, Lit
    from repro_torch.relational.sort import SortKey
    from repro_torch.sql import sql_to_plan
    from repro_torch.substrait import CapabilityRegistry

    def window():
        return FilterRel(
            WindowRel(ReadRel("lineitem", ["l_orderkey", "l_quantity"]),
                      ["l_orderkey"], [SortKey("l_quantity", False)],
                      "row_number", None, "rn"),
            BinOp("==", Col("rn"), Lit(1)))

    def union():
        halves = [ReadRel("orders", ["o_orderkey", "o_totalprice"],
                          filter=cond)
                  for cond in (Col("o_orderkey") <= Lit(1000),
                               Col("o_orderkey") > Lit(1000))]
        return AggregateRel(SetRel(halves), [],
                            [AggSpec("count_star", None, "n"),
                             AggSpec("sum", Col("o_totalprice"), "s")])

    def host_rooted():
        return WindowRel(ReadRel("lineitem", ["l_orderkey", "l_quantity"]),
                         ["l_orderkey"], [], "sum", "l_quantity", "s")

    return {
        "window_row_number": (window, None, ["device", "host", "device"],
                              [[], [0], [1]], (True, True)),
        "union_all": (union, None, ["device", "device", "host", "device"],
                      [[], [], [0, 1], [2]], (True, True)),
        # the host fragment scans orders from the engine's host copy, so
        # nothing crosses to the host
        "q13_without_like": (lambda: sql_to_plan(SQL_QUERIES[13]),
                             CapabilityRegistry(host_only_exprs=["Like"]),
                             ["host", "device"], [[], [0]], (False, True)),
        "host_rooted_window_sum": (host_rooted, None, ["device", "host"],
                                   [[], [0]], (True, True)),
    }


def run_front_door(card: str, tpch_tables: dict, tpch_db: dict,
                   cb_table, cb_db: dict, sql_runs: dict) -> dict:
    """The 37 golden wire plans and four hybrid plans through
    ``SiriusEngine.accelerate`` on the data phases 4 and 5 loaded
    (registered again with their host dicts, not regenerated)."""
    import torch
    from repro_torch.core import instrument
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.core.fallback import FallbackEngine
    from repro_torch.data import clickbench as cb
    from repro_torch.data.tpch_queries import SQL_QUERIES
    from repro_torch.kernels import build
    from repro_torch.sql import run_sql
    from repro_torch.sql.binder import DEFAULT_CATALOG
    from repro_torch.substrait import HybridRouter, emit as wire_emit, ingest

    t_phase = time.perf_counter()

    def engine(tables, host, **kw):
        e = SiriusEngine(**kw)
        for name, t in tables.items():
            e.register(name, t, host[name])
        return e

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3

    def hits_of(e, fn):
        before = e.backend.hit_counts()
        out = fn()
        after = e.backend.hit_counts()
        return out, {k: after[k] - before[k] for k in after}

    def warm_wire(e, blob, what):
        syncs = instrument.scalar_syncs.value
        barriers = instrument.sync_barriers.value
        out, ms = timed(lambda: e.accelerate(blob))
        report = e.last_accelerate_report
        if not report.get("plan_cache_hit") or not e.executor.last_plan_cache_hit:
            raise AssertionError(f"{what}: a warm wire missed the plan cache")
        got = (instrument.scalar_syncs.value - syncs,
               instrument.sync_barriers.value - barriers)
        if got != (0, 1):
            raise AssertionError(f"{what}: a warm wire took {got[0]} scalar "
                                 f"syncs and {got[1]} barriers, not 0 and 1")
        return out, ms, e.executor.last_replay_mode

    def all_device(report, what):
        got = (report["device_fragments"], report["host_fragments"],
               report["device_rel_fraction"], report["boundary_to_host_bytes"],
               report["boundary_to_device_bytes"])
        if got != (1, 0, 1.0, 0, 0):
            raise AssertionError(f"{what}: report {got}, not one device "
                                 f"fragment and no boundary bytes")

    def wire_runs(e, blob, want, what, sql_fn):
        """Cold once, warm twice, then the same query's SQL text on the
        same engine, cold and warm twice; every result held against
        ``want``.  On the kernel engine, the cold run's kernel hits."""
        before = e.backend.hit_counts() if e.backend else None
        out, cold_ms = timed(lambda: e.accelerate(blob))
        hits = None
        if before is not None:
            after = e.backend.hit_counts()
            hits = {k: after[k] - before[k] for k in after}
        all_device(e.last_accelerate_report, what)
        if out.device != e.device:
            raise AssertionError(f"{what}: the result is on {out.device}")
        err, _ = compare_tables(out.to_host(), want)
        signature = e.executor.last_plan_signature
        warms, modes = [], set()
        for _ in range(2):
            w, ms, mode = warm_wire(e, blob, what)
            compare_tables(w.to_host(), want)
            warms.append(ms)
            modes.add(mode)
        all_device(e.last_accelerate_report, what)
        with instrument.track_transfers() as counter:
            warm_wire(e, blob, what)
        sql_ms = []
        for _ in range(3):
            o, ms = timed(sql_fn)
            compare_tables(o.to_host(), want)
            sql_ms.append(ms)
        # the front door's own host steps of a cold run, apart
        ingest_ms = statistics.median(timed(lambda: ingest(blob))[1]
                                      for _ in range(5))
        plan = ingest(blob)
        route_ms = statistics.median(
            timed(lambda: HybridRouter(e).plan_fragments(plan))[1]
            for _ in range(5))
        (mode,) = modes
        return {"cold_ms": cold_ms, "warm_ms": statistics.median(warms),
                "ingest_ms": ingest_ms, "route_ms": route_ms,
                "sql_cold_ms": sql_ms[0],
                "sql_warm_ms": statistics.median(sql_ms[1:]),
                "replay": mode, "max_rel_err": err,
                "in_pipeline_copies": counter.in_pipeline,
                "signature": signature,
                **({"hits": hits} if hits is not None else {})}

    build.reset_launch_counts()
    yard = engine(tpch_tables, tpch_db, use_kernels=False,
                  compile_pipelines=False)
    engines = {"kernels": engine(tpch_tables, tpch_db, use_kernels=True),
               "graph": engine(tpch_tables, tpch_db, use_kernels=False)}
    fresh_sql = None             # a kernel engine for cold SQL-text hits
    tpch_rows = []
    for qid in sorted(SQL_QUERIES):
        blob = _golden_wire(f"tpch_q{qid}")
        text = SQL_QUERIES[qid]
        want = yard.sql(text).to_host()
        row = {"query": f"Q{qid}", "card": card,
               "rows": len(next(iter(want.values())))}
        for label, e in engines.items():
            what = f"wire Q{qid} ({label})"
            r = wire_runs(e, blob, want, what, lambda e=e: e.sql(text))
            if r["in_pipeline_copies"]:
                raise AssertionError(f"{what}: {r['in_pipeline_copies']} "
                                     f"device-to-host copies in pipelines")
            want_mode = ("graph" if label == "graph"
                         and qid in EXPECTED_GRAPH_QIDS else "closure")
            if r["replay"] != want_mode:
                raise AssertionError(
                    f"{what}: replayed by {r['replay']}, expected "
                    f"{want_mode}; capture errors: "
                    f"{e.executor.capture_errors}")
            row[label] = r
        # the cold wire's kernel hits against the SQL text's on the same
        # plan: phase 4b's first call where the engine's dictionary-costed
        # optimizer chose the wire's plan, else the text through the
        # default catalog (the wire's own producer) on a fresh engine
        sql_run = sql_runs.get(qid)
        if (sql_run and sql_run["cold"]
                and sql_run["signature"] == row["kernels"]["signature"]):
            want_hits, source = sql_run["hits"], "phase 4b sql()"
        else:
            if fresh_sql is None:
                fresh_sql = engine(tpch_tables, tpch_db, use_kernels=True)
            _, want_hits = hits_of(fresh_sql, lambda: run_sql(text, fresh_sql))
            if fresh_sql.executor.last_plan_signature != \
                    row["kernels"]["signature"]:
                raise AssertionError(f"Q{qid}: the default catalog's plan is "
                                     f"not the golden wire's")
            source = "run_sql, default catalog"
        row["sql_hits"], row["sql_hits_from"] = want_hits, source
        if row["kernels"]["hits"] != want_hits:
            raise AssertionError(f"wire Q{qid}: kernel hits "
                                 f"{row['kernels']['hits']}, the SQL path's "
                                 f"on the same plan ({source}) {want_hits}")
        for label in engines:
            del row[label]["signature"]
        emit({"phase": "front_door_tpch", **row})
        tpch_rows.append(row)

    # ClickBench: the 15 wires on the kernel engine at CB_ROWS rows
    cat = cb.clickbench_catalog(CB_ROWS)
    cb_yard = SiriusEngine(use_kernels=False, compile_pipelines=False)
    cb_yard.register("hits", cb_table)
    cb_eng = SiriusEngine(use_kernels=True)
    cb_eng.register("hits", cb_table, cb_db["hits"])
    cb_rows = []
    for qid in cb.CLICKBENCH_QUERIES:
        text = cb.CLICKBENCH_QUERIES[qid]
        want = cb_yard.sql(text, catalog=cat).to_host()
        what = f"wire ClickBench {qid}"
        r = wire_runs(cb_eng, _golden_wire(f"clickbench_{qid}"), want, what,
                      lambda: cb_eng.sql(text, catalog=cat))
        want_hits = _cb_hits(qid)
        if r["hits"] != want_hits:
            raise AssertionError(f"{what}: kernel hits {r['hits']}, the SQL "
                                 f"path's {want_hits}")
        if qid in cb.CLICKBENCH_STRING_QIDS and r["in_pipeline_copies"]:
            raise AssertionError(f"{what}: {r['in_pipeline_copies']} "
                                 f"device-to-host copies in pipelines")
        del r["signature"]
        row = {"query": qid, "card": card,
               "rows": len(next(iter(want.values()))), "kernels": r}
        emit({"phase": "front_door_clickbench", **row})
        cb_rows.append(row)

    # four hybrid plans at SF1 on the kernel engine
    kern = engines["kernels"]
    hybrid_rows = []
    for name, (plan, registry, placements, deps, positive) in \
            _hybrid_plans().items():
        blob = wire_emit(plan(), DEFAULT_CATALOG)
        h0 = kern.buffers.boundary_to_host_bytes
        d0 = kern.buffers.boundary_to_device_bytes
        got, ms = timed(lambda: kern.accelerate(blob, registry=registry))
        report = kern.last_accelerate_report
        got_place = [f["placement"] for f in report["fragments"]]
        got_deps = [f["deps"] for f in report["fragments"]]
        if (got_place, got_deps) != (placements, deps):
            raise AssertionError(f"{name}: fragments {got_place} deps "
                                 f"{got_deps}, the reference's {placements} "
                                 f"{deps}")
        moved = (report["boundary_to_host_bytes"],
                 report["boundary_to_device_bytes"])
        if moved != (kern.buffers.boundary_to_host_bytes - h0,
                     kern.buffers.boundary_to_device_bytes - d0):
            raise AssertionError(f"{name}: report {moved} is not the buffer "
                                 f"manager's counters' delta")
        if tuple(b > 0 for b in moved) != positive:
            raise AssertionError(f"{name}: boundary bytes {moved}")
        if got.device != kern.device:
            raise AssertionError(f"{name}: the result is on {got.device}")
        # the oracle: the port's FallbackEngine on the host dicts (Q13: the
        # eager engine's sql())
        if name == "q13_without_like":
            want, oracle_ms = timed(lambda: yard.sql(SQL_QUERIES[13]).to_host())
        else:
            want, oracle_ms = timed(lambda: FallbackEngine(tpch_db).execute(plan()))
        err, _ = compare_tables(got.to_host(), want)
        # each fragment's seconds: the router once more, with analyze
        again, frag_report = HybridRouter(kern, registry).execute(
            ingest(blob), analyze=True)
        row = {"plan": name, "card": card,
               "rows": len(next(iter(want.values()))),
               "accelerate_ms": ms, "oracle_ms": oracle_ms,
               "oracle": "sql() eager" if name == "q13_without_like"
               else "FallbackEngine",
               "fragments": [{**f, **{k: v for k, v in g.items()
                                      if k in ("seconds", "rows_out")}}
                             for f, g in zip(report["fragments"],
                                             frag_report["fragments"])],
               "device_rel_fraction": report["device_rel_fraction"],
               "boundary_to_host_bytes": moved[0],
               "boundary_to_device_bytes": moved[1], "max_rel_err": err}
        emit({"phase": "front_door_hybrid", **row})
        hybrid_rows.append(row)
        del got, again

    launches = build.launch_counts()
    fallbacks = sum(e.executor.fallback_queries
                    for e in (yard, cb_yard, cb_eng, *engines.values()))
    if fallbacks:
        raise AssertionError(f"{fallbacks} plans fell back to the host")
    missing = [k for k in PATH_KERNELS["front_door"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the front door: "
                             f"{missing}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "front_door", "card": card, "seconds": seconds,
          "launches": launches, "fallback_queries": fallbacks})
    return {"launches": launches, "tpch": tpch_rows, "clickbench": cb_rows,
            "hybrid": hybrid_rows, "seconds": seconds}



# ---------------------------------------------------------------------------
# phase 5c: EXPLAIN ANALYZE and the query journal
# ---------------------------------------------------------------------------


def _kernel_deltas(profile: dict) -> dict:
    """A profile's ``kernel.<name>_hits`` deltas → ``_hits``'s keys."""
    return {k[len("kernel."):-len("_hits")]: int(v)
            for k, v in profile["metrics"].items() if k.startswith("kernel.")}


def run_analyze(card: str, tpch_tables: dict, tpch_db: dict, cb_table,
                cb_db: dict) -> dict:
    """EXPLAIN ANALYZE through ``execute``, ``sql`` and ``accelerate`` on
    the data phases 4 and 5 loaded (registered again with their host
    dicts), and the journal's cost on warm replays."""
    import torch
    from repro_torch.core import instrument
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.core.fallback import FallbackEngine
    from repro_torch.data import clickbench as cb
    from repro_torch.data.tpch_queries import QUERIES, SQL_QUERIES
    from repro_torch.kernels import build
    from repro_torch.observability import (JOURNAL, QueryJournal,
                                           QueryProfile, to_chrome,
                                           validate_profile)
    from repro_torch.sql.binder import DEFAULT_CATALOG
    from repro_torch.substrait import emit as wire_emit

    t_phase = time.perf_counter()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)

    def engine(tables, host, **kw):
        e = SiriusEngine(**kw)
        for name, t in tables.items():
            e.register(name, t, host[name])
        return e

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3

    def checked(prof, rows: int, what: str) -> dict:
        """The profile's dict, valid, its last sink's rows the result's."""
        if not isinstance(prof, QueryProfile):
            raise AssertionError(f"{what}: no QueryProfile ({type(prof)})")
        d = prof.to_dict()
        errors = validate_profile(d)
        if errors:
            raise AssertionError(f"{what}: invalid profile: {errors}")
        last = d["pipelines"][-1]["operators"][-1]
        if last["rows_out"] != rows:
            raise AssertionError(f"{what}: the last sink's rows_out "
                                 f"{last['rows_out']}, the result's {rows}")
        return d

    def warm(e, fn, what: str, want_mode: str):
        syncs = instrument.scalar_syncs.value
        barriers = instrument.sync_barriers.value
        out, ms = timed(fn)
        if not e.executor.last_plan_cache_hit:
            raise AssertionError(f"{what}: a warm run missed the plan cache")
        got = (instrument.scalar_syncs.value - syncs,
               instrument.sync_barriers.value - barriers)
        if got != (0, 1):
            raise AssertionError(f"{what}: a warm run took {got[0]} scalar "
                                 f"syncs and {got[1]} barriers, not 0 and 1")
        if e.executor.last_replay_mode != want_mode:
            raise AssertionError(f"{what}: replayed by "
                                 f"{e.executor.last_replay_mode}, expected "
                                 f"{want_mode}")
        return out, ms

    def no_fragment_profiles(e, prof, what: str) -> None:
        for frags in (prof.fragments, e.last_accelerate_report["fragments"]):
            if any("_profile" in f for f in frags):
                raise AssertionError(f"{what}: a fragment kept its _profile")

    build.reset_launch_counts()
    yard = engine(tpch_tables, tpch_db, use_kernels=False,
                  compile_pipelines=False)
    engines = {"kernels": engine(tpch_tables, tpch_db, use_kernels=True),
               "graph": engine(tpch_tables, tpch_db, use_kernels=False)}
    tpch_rows = []
    costed = {label: 0 for label in engines}
    for qid in sorted(QUERIES):
        want = yard.execute(QUERIES[qid]()).to_host()
        n_rows = len(next(iter(want.values())))
        row = {"query": f"Q{qid}", "card": card, "rows": n_rows}
        for label, e in engines.items():
            what = f"analyze Q{qid} ({label})"
            want_mode = ("graph" if label == "graph" and qid in
                         EXPECTED_GRAPH_QIDS else "closure")
            e.execute(QUERIES[qid]())             # records the entry
            runs = []
            for _ in range(2):                    # the second is reported
                barriers = instrument.sync_barriers.value
                out, ms = timed(lambda: e.execute(
                    QUERIES[qid](), analyze=True, query_text=f"tpch q{qid}"))
                barriers = instrument.sync_barriers.value - barriers
                if barriers <= 1:
                    raise AssertionError(f"{what}: {barriers} barriers")
                compare_tables(out.to_host(), want)
                d = checked(e.last_profile, out.num_rows, what)
                if label == "kernels" and \
                        _kernel_deltas(d) != EXPECTED_HITS_SF1[qid]:
                    raise AssertionError(
                        f"{what}: kernel hits {_kernel_deltas(d)}, "
                        f"expected {EXPECTED_HITS_SF1[qid]}")
                runs.append((ms, barriers))
            # (a plan whose pipelines scan straight into their sinks, or
            # whose probes all run eagerly, has no fused region)
            fused = [o for p in d["pipelines"] for o in p["operators"]
                     if o["category"] == "fused"]
            costed[label] += len(fused)
            for o in fused:
                a = o["attrs"]
                if not a.get("degraded") and not (
                        a.get("est_flops", 0) > 0 and a.get("est_bytes", 0) > 0):
                    raise AssertionError(f"{what}: {o['name']} has no cost "
                                         f"estimate: {a}")
            warms = []
            for _ in range(WARM_RUNS):
                w, ms = warm(e, lambda: e.execute(QUERIES[qid]()), what,
                             want_mode)
                compare_tables(w.to_host(), want)
                warms.append(ms)
            row[label] = {
                "analyzed_ms": runs[1][0], "first_analyzed_ms": runs[0][0],
                "analyzed_barriers": runs[1][1],
                "warm_ms": statistics.median(warms), "replay": want_mode,
                "profile_total_ms": d["total_seconds"] * 1e3,
                "operator_totals_ms": {k: v * 1e3 for k, v in
                                       d["operator_totals"].items()},
                "operators": sum(len(p["operators"]) for p in d["pipelines"]),
                "fused": len(fused), "hits": _kernel_deltas(d)}
            if qid == 3 and label == "kernels":
                (out_dir / "chip_smoke_q3_profile.txt").write_text(
                    e.last_profile.pretty() + "\n")
        emit({"phase": "analyze_tpch", **row})
        tpch_rows.append(row)
    if not all(costed.values()):
        raise AssertionError(f"fused operators with cost estimates: {costed}")

    # ClickBench: the 15 queries through sql(analyze=True) on the kernel
    # engine at CB_ROWS rows
    cat = cb.clickbench_catalog(CB_ROWS)
    cb_yard = SiriusEngine(use_kernels=False, compile_pipelines=False)
    cb_yard.register("hits", cb_table)
    cb_eng = SiriusEngine(use_kernels=True)
    cb_eng.register("hits", cb_table, cb_db["hits"])
    cb_rows = []
    for qid in cb.CLICKBENCH_QUERIES:
        text = cb.CLICKBENCH_QUERIES[qid]
        what = f"analyze ClickBench {qid}"
        want = cb_yard.sql(text, catalog=cat).to_host()
        cb_eng.sql(text, catalog=cat)             # records the entry
        out, ms = timed(lambda: cb_eng.sql(text, catalog=cat, analyze=True))
        compare_tables(out.to_host(), want)
        d = checked(cb_eng.last_profile, out.num_rows, what)
        want_hits = _cb_hits(qid)
        if _kernel_deltas(d) != want_hits:
            raise AssertionError(f"{what}: kernel hits {_kernel_deltas(d)}, "
                                 f"expected {want_hits}")
        w, warm_ms = warm(cb_eng, lambda: cb_eng.sql(text, catalog=cat),
                          what, "closure")
        compare_tables(w.to_host(), want)
        row = {"query": qid, "card": card,
               "rows": len(next(iter(want.values()))), "analyzed_ms": ms,
               "warm_ms": warm_ms, "profile_total_ms": d["total_seconds"] * 1e3,
               "operator_totals_ms": {k: v * 1e3 for k, v in
                                      d["operator_totals"].items()},
               "hits": _kernel_deltas(d)}
        emit({"phase": "analyze_clickbench", **row})
        cb_rows.append(row)

    # EXPLAIN ANALYZE through sql(), one all-device wire and the four
    # hybrid plans through accelerate(analyze=True), on the kernel engine
    kern = engines["kernels"]
    prof, ms = timed(lambda: kern.sql("EXPLAIN ANALYZE " + SQL_QUERIES[6]))
    checked(prof, 1, "EXPLAIN ANALYZE Q6")
    if prof is not kern.last_profile or not prof.query.startswith("select"):
        raise AssertionError(f"EXPLAIN ANALYZE Q6: query {prof.query!r}")
    front = [{"what": "EXPLAIN ANALYZE Q6", "ms": ms}]
    out, ms = timed(lambda: kern.accelerate(_golden_wire("tpch_q3"),
                                            analyze=True))
    compare_tables(out.to_host(), yard.sql(SQL_QUERIES[3]).to_host())
    prof = kern.last_profile
    checked(prof, out.num_rows, "wire Q3 analyzed")
    no_fragment_profiles(kern, prof, "wire Q3 analyzed")
    if [f["placement"] for f in prof.fragments] != ["device"] or not all(
            p.source.startswith("frag0:") for p in prof.pipelines):
        raise AssertionError(f"wire Q3 analyzed: fragments {prof.fragments}")
    front.append({"what": "wire Q3", "ms": ms,
                  "pipelines": len(prof.pipelines)})
    for name, (plan, registry, placements, _, _) in _hybrid_plans().items():
        what = f"hybrid {name} analyzed"
        blob = wire_emit(plan(), DEFAULT_CATALOG)
        out, ms = timed(lambda: kern.accelerate(blob, registry=registry,
                                                analyze=True))
        prof = kern.last_profile
        d = prof.to_dict()
        if validate_profile(d):
            raise AssertionError(f"{what}: {validate_profile(d)}")
        no_fragment_profiles(kern, prof, what)
        got_place = [f["placement"] for f in prof.fragments]
        host_ops = [p.operators[0].name for p in prof.pipelines
                    if p.source.endswith(":host")]
        if got_place != placements or \
                host_ops != ["HostFragment"] * placements.count("host"):
            raise AssertionError(f"{what}: fragments {got_place}, host "
                                 f"operators {host_ops}")
        if name == "q13_without_like":
            want = yard.sql(SQL_QUERIES[13]).to_host()
        else:
            want = FallbackEngine(tpch_db).execute(plan())
        compare_tables(out.to_host(), want)
        front.append({"what": what, "ms": ms, "fragments": [
            {k: f[k] for k in ("fid", "placement", "seconds", "rows_out")}
            for f in prof.fragments]})
        del out
    for r in front:
        emit({"phase": "analyze_front_door", "card": card, **r})

    # the journal on and off on warm replays of Q1 and Q6: interleaved
    # runs, on first in even rounds and off first in odd ones
    journal = []
    for label, e in engines.items():
        for qid in (1, 6):
            what = f"journal Q{qid} ({label})"
            want_mode = ("graph" if label == "graph" and qid in
                         EXPECTED_GRAPH_QIDS else "closure")
            times = {True: [], False: []}
            try:
                for i in range(JOURNAL_REPEATS):
                    for on in ((True, False) if i % 2 == 0 else (False, True)):
                        (JOURNAL.enable if on else JOURNAL.disable)()
                        xfer = e.buffers.host_transfer_bytes
                        _, ms = warm(e, lambda: e.execute(QUERIES[qid]()),
                                     what, want_mode)
                        if e.buffers.host_transfer_bytes != xfer:
                            raise AssertionError(f"{what}: transfer bytes")
                        times[on].append(ms)
            finally:
                JOURNAL.enable()
            with instrument.track_transfers() as counter:
                warm(e, lambda: e.execute(QUERIES[qid]()), what, want_mode)
            if counter.in_pipeline:
                raise AssertionError(f"{what}: {counter.in_pipeline} copies "
                                     f"in pipelines with the journal on")
            t_on = statistics.median(times[True]) / 1e3
            t_off = statistics.median(times[False]) / 1e3
            if not t_on <= t_off * 1.05 + 0.002:
                raise AssertionError(f"{what}: {t_on * 1e3:.4f} ms on, "
                                     f"{t_off * 1e3:.4f} ms off")
            row = {"query": f"Q{qid}", "engine": label, "card": card,
                   "on_ms": t_on * 1e3, "off_ms": t_off * 1e3,
                   "on_quartiles_ms": statistics.quantiles(times[True], n=4),
                   "off_quartiles_ms": statistics.quantiles(times[False], n=4),
                   "on_ms_all": times[True], "off_ms_all": times[False]}
            emit({"phase": "analyze_journal", **{k: v for k, v in row.items()
                                                 if not k.endswith("_all")}})
            journal.append(row)

    # the journal calls a warm run makes (a query span, the replay span and
    # the query span's attributes), timed alone on a journal of their own
    span_us = {}
    watermarks = engines["graph"].buffers.watermarks()
    for on in (True, False, True, False):
        j = QueryJournal(capacity=65536, enabled=on)
        t = time.perf_counter()
        for _ in range(SPAN_CALLS):
            with j.query_span("engine.execute") as jspan:
                with j.span("plan_cache.replay", "cache", mode="graph"):
                    pass
                jspan.set(plan_cache_hit=True, compile_seconds=0.0,
                          **watermarks)
        span_us.setdefault("on" if on else "off", []).append(
            (time.perf_counter() - t) / SPAN_CALLS * 1e6)
    emit({"phase": "analyze_journal_spans", "card": card,
          "calls": SPAN_CALLS, "us_per_warm_run": span_us})

    # a Chrome trace of one query: Q3's SQL text on the graph engine
    graph = engines["graph"]
    graph.sql(SQL_QUERIES[3])
    trace = to_chrome(JOURNAL.events(graph.last_query_id), epoch=JOURNAL.epoch)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    lanes = [e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"]
    if not spans or lanes != ["coordinator"] or \
            not all(e["dur"] > 0 for e in spans):
        raise AssertionError(f"Chrome trace: lanes {lanes}, spans {spans}")
    (out_dir / "chip_smoke_trace_q3.json").write_text(json.dumps(trace))

    launches = build.launch_counts()
    missing = [k for k in PATH_KERNELS["analyze"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the analyzed "
                             f"phase: {missing}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "analyze", "card": card, "seconds": seconds,
          "launches": launches, "journal_events": JOURNAL.summary()})
    return {"launches": launches, "tpch": tpch_rows, "clickbench": cb_rows,
            "front_door": front, "journal": journal,
            "journal_span_us": span_us, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 5d: distributed execution on logical shards
# ---------------------------------------------------------------------------


def _dist_row(eng, qid, cold_s: float, warm_s: float, names) -> dict:
    """One distributed query's line: fragments, exchanges, timers, times."""
    return {"query": qid, "fragments": len(names),
            "exchanges": [{k: s[k] for k in ("fragment", "kind", "key",
                                             "bytes_per_shard", "skew_ratio",
                                             "rows_out")}
                          for s in eng.exchange_summary()],
            "timers_ms": {k: eng.timers[k] * 1e3 for k in DIST_TIMERS},
            "cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3}


def run_distributed(card: str, dev, tpch_tables: dict, tpch_db: dict,
                    cb_table, cb_db: dict) -> dict:
    """``DistributedEngine`` on ``DIST_SHARDS`` logical shards sharing the
    card: the 22 TPC-H plans with and without the kernels, the 15
    ClickBench queries with them, and the fault scenarios of
    ``tests/_dist_worker.py`` on ``DIST_FAULT_SHARDS`` shards, every result
    held against the eager engine on the same card (phase 4's yardstick,
    over phase 4's and 5's tensors) within ``DIST_RTOL``."""
    import tempfile

    import torch
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.core.plan import AggregateRel, ReadRel, SortRel
    from repro_torch.data import clickbench as cb
    from repro_torch.data.tpch import load_into_engine
    from repro_torch.data.tpch_queries import QUERIES
    from repro_torch.kernels import build
    from repro_torch.observability.dist import verify_tree
    from repro_torch.observability.journal import JOURNAL
    from repro_torch.observability.metrics import METRICS
    from repro_torch.relational.aggregate import AggSpec
    from repro_torch.relational.expressions import Col
    from repro_torch.relational.sort import SortKey
    from repro_torch.relational.table import Table
    from repro_torch.runtime.control import FaultInjector, FaultPlan
    from repro_torch.sql import sql_to_plan

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    fallbacks = METRICS.counter("distributed.shard_fallbacks")
    fallbacks0 = fallbacks.value

    def eager(tables: dict):
        e = SiriusEngine(use_kernels=False, compile_pipelines=False)
        for name, t in tables.items():
            e.register(name, t)
        return e

    def dist(db, n=DIST_SHARDS, **kw):
        t = time.perf_counter()
        e = DistributedEngine(db, n_shards=n, device=dev, **kw)
        torch.cuda.synchronize()
        return e, time.perf_counter() - t

    def timed(eng, plan_fn):
        t = time.perf_counter()
        out = eng.run_plan(plan_fn())
        return out, time.perf_counter() - t

    def checked(eng, got, want, what: str) -> float:
        err, _ = compare_tables(got, want, rtol=DIST_RTOL)
        evs = JOURNAL.events(eng.last_query_id)
        problems = verify_tree(evs, eng.last_query_id)
        if problems:
            raise AssertionError(f"{what}: journal tree {problems[:3]}")
        if fallbacks.value != fallbacks0:
            raise AssertionError(f"{what}: {fallbacks.value - fallbacks0} "
                                 f"shard(s) fell back to the host")
        return err

    def sweep(eng, plans: dict, wants: dict, what: str, warm_runs: int):
        rows = []
        for qid, plan_fn in plans.items():
            names = eng.program_names(plan_fn())
            got, cold = timed(eng, plan_fn)
            err = checked(eng, got, wants[qid], f"{what} {qid}")
            warm = [timed(eng, plan_fn) for _ in range(warm_runs)]
            for out, _ in warm:
                compare_tables(out, wants[qid], rtol=DIST_RTOL)
            row = _dist_row(eng, qid, cold, statistics.median(
                s for _, s in warm) if warm else float("nan"), names)
            row["max_rel_err"] = err
            emit({"phase": "distributed_query", "engine": what, **row})
            rows.append(row)
        return rows

    # the yardstick: the eager engine over phase 4's and 5's tensors
    yard = eager(tpch_tables)
    tpch_plans = {f"Q{q}": (lambda q=q: QUERIES[q]()) for q in sorted(QUERIES)}
    tpch_want = {k: yard.execute(fn()).to_host() for k, fn in tpch_plans.items()}
    cat = cb.clickbench_catalog(CB_ROWS)
    cb_plans = {q: (lambda sql=sql: sql_to_plan(sql, catalog=cat))
                for q, sql in cb.CLICKBENCH_QUERIES.items()}
    cb_yard = eager({"hits": cb_table})
    cb_want = {k: cb_yard.execute(fn()).to_host() for k, fn in cb_plans.items()}
    del yard, cb_yard

    result = {"shards": DIST_SHARDS, "launches_by_sweep": {}, "load_s": {}}

    # TPC-H with the kernels: every kernel of the TPC-H path must launch
    eng, result["load_s"]["tpch_kernels"] = dist(tpch_db, use_kernels=True)
    build.reset_launch_counts()
    result["tpch_kernels"] = sweep(eng, tpch_plans, tpch_want, "kernels",
                                   WARM_RUNS)
    launches = build.launch_counts()
    result["launches_by_sweep"]["tpch_kernels"] = launches
    missing = [k for k in PATH_KERNELS["distributed_tpch"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the distributed "
                             f"TPC-H path: {missing}")
    del eng

    # TPC-H on the generic tier: no kernel may launch
    eng, result["load_s"]["tpch_generic"] = dist(tpch_db, use_kernels=False)
    build.reset_launch_counts()
    result["tpch_generic"] = sweep(eng, tpch_plans, tpch_want, "generic",
                                   DIST_GENERIC_WARM_RUNS)
    launched = {k: n for k, n in build.launch_counts().items() if n}
    if launched:
        raise AssertionError(f"the generic tier launched kernels: {launched}")
    del eng

    # ClickBench with the kernels (ORDER BY ... LIMIT tails run on the
    # coordinator's host engine, as in the reference: no top-k here)
    eng, result["load_s"]["clickbench"] = dist(cb_db, use_kernels=True)
    build.reset_launch_counts()
    result["clickbench"] = sweep(eng, cb_plans, cb_want, "clickbench",
                                 WARM_RUNS)
    launches = build.launch_counts()
    result["launches_by_sweep"]["clickbench"] = launches
    missing = [k for k in PATH_KERNELS["distributed_clickbench"]
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the distributed "
                             f"ClickBench path: {missing}")
    del eng

    # the fault scenarios of tests/_dist_worker.py at SF1, Q3
    build.reset_launch_counts()
    faults = {}
    q3 = tpch_plans["Q3"]
    with tempfile.TemporaryDirectory() as d:
        eng, _ = dist(tpch_db, DIST_FAULT_SHARDS, use_kernels=True,
                      checkpoint_dir=d)
        names = eng.program_names(3)
        target = names[-2]
        got, _ = timed(eng, q3)
        checked(eng, got, tpch_want["Q3"], "fault: first run")
        # checkpoint: a new engine resumes after the second-to-last fragment
        eng2, _ = dist(tpch_db, DIST_FAULT_SHARDS, use_kernels=True,
                       checkpoint_dir=d)
        t = time.perf_counter()
        got = eng2.run_query(3, resume=True)
        s = time.perf_counter() - t
        checked(eng2, got, tpch_want["Q3"], "fault: checkpoint resume")
        if eng2.timers.get("resumed_from") != len(names) - 1:
            raise AssertionError(f"resumed from {eng2.timers.get('resumed_from')}"
                                 f", expected {len(names) - 1}")
        faults["checkpoint"] = {"resumed_from": eng2.timers["resumed_from"],
                                "fragments": len(names), "ms": s * 1e3}
        # node failure: one recovery, one shard fewer, the same result
        inj = FaultInjector([FaultPlan(fragment=target, node=3, times=1)])
        eng2.injector = inj
        got, s = timed(eng2, q3)
        checked(eng2, got, tpch_want["Q3"], "fault: node failure")
        if (eng2.recoveries, eng2.n_shards, inj.tripped) != \
                (1, DIST_FAULT_SHARDS - 1, [target]):
            raise AssertionError(
                f"node failure: recoveries {eng2.recoveries}, shards "
                f"{eng2.n_shards}, tripped {inj.tripped}")
        faults["node_failure"] = {"recoveries": eng2.recoveries,
                                  "shards_after": eng2.n_shards,
                                  "ms": s * 1e3}
        del eng2
        # straggler: a delay well past the speculation budget; the backup's
        # result is taken, and the primary that wakes after it never runs
        # the fragment
        sr = eng.speculative
        budget = max(sr.min_budget_s,
                     sr.budget_factor * sr.history.get(target, 0.0))
        delay = max(STRAGGLE_S, 2 * budget)
        eng.injector = FaultInjector([FaultPlan(fragment=target, node=2,
                                                times=1, delay_s=delay)])
        n_spec = len(sr.speculated)
        got, s = timed(eng, q3)
        checked(eng, got, tpch_want["Q3"], "fault: straggler")
        qid = eng.last_query_id
        backups = [e["attrs"]["fragment"] for e in JOURNAL.events(qid)
                   if e["name"] == "speculative_backup"]
        if target not in sr.speculated[n_spec:] or target not in backups:
            raise AssertionError(f"straggler: {target} not speculated "
                                 f"({sr.speculated[n_spec:]}, {backups})")
        time.sleep(delay + 1.0)
        late = [e for e in JOURNAL.events(qid) if e["cat"] == "attempt"
                and e["name"] == f"{target}:primary"]
        if late:
            raise AssertionError(f"straggler: the late primary ran ({late[0]})")
        faults["straggler"] = {"speculated": list(sr.speculated),
                               "delay_s": delay, "ms": s * 1e3}
        # predicate transfer: on Q3 (whose placement has no shuffle join to
        # pre-filter) and on Q10 (whose lineitem shuffle it prunes by the
        # date-filtered orders)
        pruned = METRICS.counter("distributed.predicate_transfer_rows_pruned")
        eng.predicate_transfer = True
        for q in ("Q3", "Q10"):
            pruned0 = pruned.value
            got, s = timed(eng, tpch_plans[q])
            checked(eng, got, tpch_want[q], f"fault: predicate transfer {q}")
            faults[f"predicate_transfer_{q}"] = {
                "rows_pruned": pruned.value - pruned0, "ms": s * 1e3}
        if not faults["predicate_transfer_Q10"]["rows_pruned"]:
            raise AssertionError("predicate transfer pruned no row of Q10")
        del eng
    # prime row counts: every pad-and-mask boundary uneven
    primes = {"lineitem": 9973, "orders": 2503, "customer": 251,
              "part": 331, "supplier": 13, "partsupp": 1327}
    pdb = {t: {c: v[:primes.get(t, len(v))] for c, v in cols.items()}
           for t, cols in tpch_db.items()}
    pyard = SiriusEngine(use_kernels=False, compile_pipelines=False)
    load_into_engine(pyard, pdb)
    eng, _ = dist(pdb, DIST_FAULT_SHARDS, use_kernels=True)
    for q in (1, 3, 6, 12, 18):
        got, _ = timed(eng, tpch_plans[f"Q{q}"])
        checked(eng, got, pyard.execute(QUERIES[q]()).to_host(),
                f"fault: prime rows Q{q}")
    faults["prime_rows"] = {t: len(next(iter(c.values())))
                            for t, c in pdb.items()}
    # shuffle overflow: undersized buckets double until they fit
    rng = np.random.default_rng(7)
    n = 20_000
    sdb = {"t": {"k": rng.integers(0, 9973, n),
                 "p": rng.integers(0, 1 << 30, n), "v": rng.normal(size=n)}}
    plan = (lambda: SortRel(AggregateRel(ReadRel("t"), ["k"],
                                         [AggSpec("sum", Col("v"), "s")]),
                            [SortKey("k", True)]))
    eng, _ = dist(sdb, 4, use_kernels=True, shuffle_slack=0.01,
                  partition_keys={"t": "p"})
    got, s = timed(eng, plan)
    checked(eng, got, eager({"t": Table.from_pydict(sdb["t"])}).execute(
        plan()).to_host(), "fault: shuffle overflow")
    if not eng.shuffle_slack > 0.01:
        raise AssertionError(f"overflow: slack {eng.shuffle_slack}")
    faults["overflow"] = {"final_slack": eng.shuffle_slack, "ms": s * 1e3}
    del eng
    result["faults"] = faults
    result["launches_by_sweep"]["faults"] = build.launch_counts()
    emit({"phase": "distributed_faults", **faults})

    torch.cuda.synchronize()
    launches = {k: sum(c[k] for c in result["launches_by_sweep"].values())
                for k in REPLACES}
    result.update(launches=launches,
                  seconds=time.perf_counter() - t_phase,
                  peak_device_bytes=torch.cuda.max_memory_allocated(),
                  shard_fallbacks=fallbacks.value - fallbacks0)
    emit({"phase": "distributed", "card": card, "shards": DIST_SHARDS,
          "fault_shards": DIST_FAULT_SHARDS, "seconds": result["seconds"],
          "peak_device_bytes": result["peak_device_bytes"],
          "load_s": result["load_s"], "launches": result["launches_by_sweep"],
          "shard_fallbacks": result["shard_fallbacks"]})
    return result


# ---------------------------------------------------------------------------
# phase 5e: the SQL half of launch/ (dry run, then the fragments on shards)
# ---------------------------------------------------------------------------


def _launch_mesh(n: int, multi_pod: bool, dev):
    from repro_torch.exchange.service import ShardMesh
    if multi_pod:
        return ShardMesh((("pod", 2), ("data", n // 2)), dev)
    return ShardMesh((("data", n),), dev)


def _dry_line(rec: dict) -> dict:
    mem = rec["memory"]
    return {k: rec.get(k) for k in ("shape", "mesh", "status", "n_shards",
                                    "caps", "cap", "shuffle_out_caps")} | {
        "argument_bytes": mem["argument_bytes"],
        "output_bytes": mem["output_bytes"],
        "peak_bytes": mem["resident_bytes_per_chip"],
        "bytes_accessed": rec["bytes_accessed_per_device"],
        "collective_bytes": rec["collective_bytes_per_device"],
        "fits_card": mem["fits_card"]}


def run_launch(card: str, dev) -> dict:
    """The dry run of the ten SQL cells, then each fragment run for real on
    logical shards of the card and held against the plain answer."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, sql_data, sql_dryrun

    t_phase = time.perf_counter()
    build.reset_launch_counts()
    budget = LAUNCH_MEM_SHARE * torch.cuda.get_device_properties(0).total_memory
    dry = {}
    for shape in sql_dryrun.SHAPES:
        for mp in (False, True):
            rec = dryrun.run_cell(dryrun.SQL_ARCH, f"{shape}_sf100", mp)
            if rec["status"] != "ok":
                raise AssertionError(f"dry run {shape} {mp}: {rec['error']}")
            dry[(shape, mp)] = rec
            emit({"phase": "launch_dry", "card": card, **_dry_line(rec)})

    runs = []
    for (shape, mp), rec in dry.items():
        # the largest n whose prediction fits (per-shard caps of SF100/256)
        per_shard = dry[(shape, False)]["memory"]["resident_bytes_per_chip"]
        n = next((n for n in LAUNCH_SHARDS if n * per_shard <= budget), 8)
        while True:
            sf = sql_dryrun.SF * n / 256
            fn, specs, extra = sql_dryrun.lower_sql_fragment(
                shape, mp, sf=sf, mesh=_launch_mesh(n, mp, dev))
            pred = dryrun.analyze(fn, specs, _launch_mesh(n, mp, dev))
            predicted = n * pred["memory"]["resident_bytes_per_chip"]
            if predicted <= budget or n == 8:
                break
            n //= 2
        mesh = _launch_mesh(n, mp, dev)
        torch.cuda.empty_cache()
        if shape == "q1":
            data = sql_data.q1_data(extra, sf, LAUNCH_SEED, device=dev)
        else:
            data = sql_data.q3_data(extra, sf, LAUNCH_SEED,
                                    compress="c" in shape, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(1 + WARM_RUNS):
            t = time.perf_counter()
            got = fn(mesh, *data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        warm = statistics.median(times[1:])
        bound_ms = n * pred["bytes_accessed_per_device"] / HBM_BYTES_PER_S * 1e3
        row = {"shape": shape, "mesh": "x".join(map(str, mesh.shape)),
               "n_shards": n, "sf": sf, "cold_ms": times[0], "warm_ms": warm,
               "peak_bytes": peak, "predicted_peak_bytes": predicted,
               "peak_over_predicted": peak / predicted,
               "bytes_accessed": n * pred["bytes_accessed_per_device"],
               "bound_ms": bound_ms, "bound_share": bound_ms / warm}
        if shape == "q1":
            row["max_rel_err"] = sql_data.hold_q1(
                got, sql_data.plain_q1(*data), LAUNCH_Q1_RTOL)
        else:
            plain = sql_data.plain_q3(data, extra, 2 if mp else 1,
                                      "pt" in shape)
            row.update(overflow=int(got[-1]), plain_overflow=plain["overflow"],
                       bloom_pass=plain["bloom_pass"])
            if int(got[-1]) != plain["overflow"]:
                raise AssertionError(f"{shape} {row['mesh']}: overflow "
                                     f"{int(got[-1])}, plain {plain['overflow']}")
            if "pt" not in shape and plain["overflow"]:
                raise AssertionError(f"{shape} {row['mesh']}: rows overflow")
            if not plain["overflow"]:
                row["max_rel_err"] = sql_data.hold_q3(got, plain, n,
                                                      LAUNCH_Q3_RTOL)
        del got, data
        runs.append(row)
        emit({"phase": "launch_run", "card": card, **row})
    counts = build.launch_counts()
    result = {"dry": [_dry_line(r) for r in dry.values()], "runs": runs,
              "launches": {k: counts.get(k, 0) for k in REPLACES},
              "seconds": time.perf_counter() - t_phase}
    emit({"phase": "launch", "card": card, "seconds": result["seconds"],
          "launches": result["launches"]})
    return result


# ---------------------------------------------------------------------------
# phase 6: the LM serving path (llama3.2-3b at full width)
# ---------------------------------------------------------------------------


def _greedy_check(forward, chosen, what: str,
                  limit: float = LOGPROB_LIMIT) -> dict:
    """Hold the tokens ``chosen`` against the forward logits' argmax
    wherever the forward's top-2 margin exceeds twice ``limit``: an error
    of at most the limit in each log-prob moves a margin by at most twice
    it, so it cannot flip such a token."""
    margin = 2 * limit
    top2 = forward.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > margin
    agree = forward.argmax(-1) == chosen
    if not bool(agree[sure].all()):
        raise AssertionError(f"{what}: {int((~agree[sure]).sum())} greedy "
                             f"tokens differ where the forward's margin "
                             f"exceeds {margin}")
    return {"positions": int(agree.numel()), "positions_held": int(sure.sum()),
            "greedy_agree_share": float(agree.float().mean())}


class _RouterLog:
    """While entered, records the router logits of every ``MoE.route`` call
    (float32, as the call computes them), in call order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import layers
        self._layers, self._route = layers, layers.MoE.route
        route, calls = self._route, self.calls

        def logged(mod, xf, router):
            calls.append((id(mod), xf.to(torch.float32)
                          @ router.to(torch.float32)))
            return route(mod, xf, router)

        layers.MoE.route = logged
        return self

    def __exit__(self, *exc):
        self._layers.MoE.route = self._route


def _held_positions(fwd: _RouterLog, dec: _RouterLog, b: int, s: int,
                    k: int, what: str):
    """Where the forward and the teacher-forced decode pick other top-k
    experts (a router logit tie within float32 noise goes either way), the
    two paths compute other functions from that token on.  → (mask (b, s)
    of the positions before each row's first such token, summary); the
    first flip of each row must be at a tie: the forward's k-th and
    (k+1)-th router logits within ROUTE_TIE."""
    import torch
    layers = {}
    for mid, lg in fwd.calls:
        layers[mid] = (lg.reshape(b, s, -1), [])
    for mid, lg in dec.calls:
        layers[mid][1].append(lg)
    flips, gaps, diffs = [], [], []
    for f, d in layers.values():
        d = torch.stack(d, dim=1)

        def pick(x):
            return x.topk(k, dim=-1).indices.sort(dim=-1).values

        flips.append((pick(f) != pick(d)).any(-1))
        top = f.topk(k + 1, dim=-1).values
        gaps.append(top[..., k - 1] - top[..., k])
        diffs.append((f - d).abs().amax(-1))
    flips, gaps = torch.stack(flips), torch.stack(gaps)     # (layers, b, s)
    diffs = torch.stack(diffs)
    held = torch.ones((b, s), dtype=torch.bool, device=flips.device)
    ties = []
    for row in range(b):
        at = flips[:, row].any(0).nonzero()
        if at.numel() == 0:
            continue
        pos = int(at[0])
        layer = int(flips[:, row, pos].nonzero()[0])
        gap = float(gaps[layer, row, pos])
        if not gap < ROUTE_TIE:
            raise AssertionError(f"{what}: row {row} routes token {pos} of "
                                 f"layer {layer} differently where the "
                                 f"forward's top-{k} margin is {gap:.3g}")
        held[row, pos:] = False
        ties.append({"row": row, "position": pos, "moe_layer": layer,
                     "logit_gap": gap})
    # how far the two paths' router logits lie apart where they are compared
    noise = float(diffs[:, held].max()) if bool(held.any()) else 0.0
    return held, {"route_flips": int(flips.sum()), "first_flips": ties,
                  "router_logit_max_diff": noise}


def _decode_vs_forward(cfg, seed: int, dev, limit: float = LOGPROB_LIMIT,
                       hold: bool = True) -> dict:
    """Teacher-forced decode_step logits against logits_fn(forward(...)) for
    a model and LM_CHECK tokens drawn from ``seed``: max |delta log-softmax|
    within ``limit``, greedy tokens by ``_greedy_check``.  With MoE layers,
    over the positions before a row's first token that the two paths route
    to other experts (``_held_positions``).  An encoder-decoder takes
    standard normal frames from the same seed (the decode cache holds their
    encoding), a VLM an empty image prefix (the text-only backbone).
    ``hold=False`` only reads the error (and whether it is within
    ``limit``)."""
    import contextlib
    import torch
    from repro_torch.models.lm import CausalLM
    vocab = cfg.vocab
    model = CausalLM(cfg, device=dev, seed=seed)
    b, s = LM_CHECK
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, vocab, (b, s))).to(dev)
    extra = {}
    if cfg.enc_layers:
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model), np.float32)).to(dev)
    if cfg.n_img_tiles:
        extra["img_embeds"] = torch.zeros((b, 0, cfg.d_model), device=dev)

    def log():
        return _RouterLog() if cfg.moe else contextlib.nullcontext()

    with torch.inference_mode():
        with log() as fwd_log:
            forward = model.logits_fn(model.forward(toks, **extra))[..., :vocab]
        cache = model.init_cache(b, s)
        if cfg.enc_layers:
            cache["enc_out"] = model.encode(extra["frames"])
        steps = []
        with log() as dec_log:
            for i in range(s):
                logits, cache = model.decode_step(cache, toks[:, i:i + 1])
                steps.append(logits[:, 0, :vocab])
        decoded = torch.stack(steps, dim=1)
    del model, cache
    what = f"{cfg.name} decode vs forward (seed {seed}, {cfg.dtype})"
    routing = {}
    held = torch.ones((b, s), dtype=torch.bool, device=decoded.device)
    if cfg.moe:
        held, routing = _held_positions(fwd_log, dec_log, b, s,
                                        cfg.moe.top_k, what)
    err = float((torch.log_softmax(decoded[held], -1)
                 - torch.log_softmax(forward[held], -1)).abs().max())
    if not hold:
        agree = decoded.argmax(-1) == forward.argmax(-1)
        return {"seed": seed, "max_abs_logprob_err": err,
                "within_limit": err <= limit, "held": False,
                "greedy_agree_share": float(agree.float().mean())}
    if not err <= limit:
        raise AssertionError(f"{what}: max |delta log-softmax| {err:.4g} "
                             f"exceeds {limit}")
    return {"seed": seed, "max_abs_logprob_err": err,
            "positions_compared": int(held.sum()), **routing,
            **_greedy_check(forward[held], decoded.argmax(-1)[held], what,
                            limit)}


def run_lm_serve(card: str, dev) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.lm import CausalLM
    from repro_torch.serve_lm import (ARCH, BATCH, MAX_CACHE, N_NEW, SEED,
                                      serve, serve_metrics, workload_prompts)

    cfg = get_config(ARCH)
    vocab = cfg.vocab
    checks = []
    for seed in range(SEED, SEED + LM_CHECK_SEEDS):
        checks.append(_decode_vs_forward(cfg, seed, dev))
        emit({"phase": "lm_decode_vs_forward", "prompts": LM_CHECK[0],
              "tokens": LM_CHECK[1], "limit": LOGPROB_LIMIT,
              "greedy_margin": 2 * LOGPROB_LIMIT, **checks[-1]})
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = CausalLM(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    init = {"arch": cfg.name, "layers": len(model.blocks), "d_model": cfg.d_model,
            "dtype": str(model.dtype), "init_s": time.perf_counter() - t0,
            "weight_bytes": weights,
            "params": sum(p.numel() for p in model.parameters())}
    emit({"phase": "lm_init", **init})

    # serving: the main path, counted from 0
    prompts = workload_prompts(vocab)
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    result = serve(model, prompts, N_NEW, MAX_CACHE)
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = result["prefill_steps"] + N_NEW
    if launches["decode_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"decode_attention launched "
                             f"{launches['decode_attention']} times over "
                             f"{steps} decode steps of {cfg.n_layers} layers")
    tokens = np.asarray(result["tokens"])
    if tokens.shape != (BATCH, N_NEW) or tokens.min() < 0 or tokens.max() >= vocab:
        raise AssertionError(f"served tokens: shape {tokens.shape}, range "
                             f"{tokens.min()}..{tokens.max()}")
    # every generated token against the forward's greedy choice over the
    # same sequence: the padded prompts (token 0 past a prompt's end, as
    # serve feeds them) then the generated tokens
    maxp = result["prefill_steps"]
    seq = np.zeros((BATCH, maxp + N_NEW - 1), np.int64)
    for i, p in enumerate(prompts):
        seq[i, :len(p)] = p
    seq[:, maxp:] = tokens[:, :-1]
    with torch.inference_mode():
        hidden = model.forward(torch.from_numpy(seq).to(dev))
        forward = model.logits_fn(hidden[:, maxp - 1:])[..., :vocab]
    served = _greedy_check(forward, torch.from_numpy(tokens).to(dev),
                           "served tokens")
    del hidden, forward
    out = {"card": card, "requests": BATCH,
           "prompt_lengths": [len(p) for p in prompts], "n_new": N_NEW,
           "max_cache": MAX_CACHE,
           **step_bound(model, BATCH),
           "kv_cache_bytes": cfg.n_layers * 2 * BATCH * MAX_CACHE
           * cfg.n_kv_heads * cfg.resolved_head_dim * 2,
           **serve_metrics(result),
           "prefill_s": result["prefill_s"], "decode_s": result["decode_s"],
           "prefill_steps": maxp, "decode_steps": N_NEW,
           "decode_attention_launches": launches["decode_attention"],
           "launches_per_step": launches["decode_attention"] / steps,
           "peak_memory_bytes": peak,
           "served_tokens_held": served["positions_held"],
           "served_greedy_agree_share": served["greedy_agree_share"],
           "decode_vs_forward": checks, "init": init}
    emit({"phase": "lm_serve", **{k: v for k, v in out.items()
                                  if k not in ("decode_vs_forward", "init")}})
    print(f"lm_serve {cfg.name}: prefill {out['prefill_tokens_per_s']:.1f} "
          f"tokens/s, decode {out['decode_tokens_per_s']:.1f} tokens/s, median "
          f"step {out['median_step_ms']:.3f} ms, decode_attention "
          f"{out['decode_attention_launches']} launches "
          f"({out['launches_per_step']:.0f} per step), peak memory "
          f"{peak} bytes on {card}", flush=True)
    return {**out, "launches": launches}


# ---------------------------------------------------------------------------
# phase 6b: the MoE, MLA and Mamba families (phi3.5-moe, deepseek-v2-lite,
# falcon-mamba, jamba) at full width
# ---------------------------------------------------------------------------


def _teacher_forced_argmax(model, prompts, tokens, vocab: int, frames=None):
    """The argmax of decode_step's logits where ``serve`` chose each of
    ``tokens``: the padded prompts (token 0 past a prompt's end, as serve
    feeds them) then the generated tokens, teacher-forced through a new
    cache of the same batch and rows (an encoder-decoder's holding the
    encoding of ``frames``)."""
    import torch
    from repro_torch.serve_lm import MAX_CACHE
    dev = model.device
    batch, n_new = tokens.shape
    maxp = max(len(p) for p in prompts)
    seq = np.zeros((batch, maxp + n_new - 1), np.int64)
    for i, p in enumerate(prompts):
        seq[i, :len(p)] = p
    seq[:, maxp:] = tokens[:, :-1]
    seq_t = torch.from_numpy(seq).to(dev)
    cache = model.init_cache(batch, MAX_CACHE)
    chosen = []
    with torch.inference_mode():
        if model.cfg.enc_layers:
            cache["enc_out"] = model.encode(torch.as_tensor(frames, device=dev))
        for i in range(seq.shape[1]):
            logits, cache = model.decode_step(cache, seq_t[:, i:i + 1])
            if i >= maxp - 1:
                chosen.append(logits[:, 0, :vocab].argmax(-1))
    return torch.stack(chosen, dim=1).cpu().numpy()


def _init_row(model, cfg, t0: float) -> dict:
    import torch
    torch.cuda.synchronize()
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
            "dtype": str(model.dtype), "init_s": time.perf_counter() - t0,
            "weight_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
            "params": sum(p.numel() for p in model.parameters())}


def _serve_held(model, prompts, what: str, frames=None) -> tuple:
    """``serve_lm``'s workload on ``model``, the main path, its launches
    counted from 0: ``decode_attention`` must launch once per attention
    layer and step, the tokens lie in ``[0, vocab)``, and every served
    token must equal the argmax of a teacher-forced ``decode_step`` re-run
    over the same sequence in the same batch (the decode step is
    deterministic: the MoE combine adds in a fixed order).  → (serve's
    result, the launches, the peak device bytes, the attention layers)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.serve_lm import BATCH, MAX_CACHE, N_NEW, serve
    dev, vocab = model.device, model.cfg.vocab
    n_attn = sum(k.mixer == "attn" for k in model.plan)
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    result = serve(model, prompts, N_NEW, MAX_CACHE, frames)
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = result["prefill_steps"] + N_NEW
    if launches["decode_attention"] != n_attn * steps:
        raise AssertionError(f"{what}: decode_attention launched "
                             f"{launches['decode_attention']} times over "
                             f"{steps} steps of {n_attn} attention layers")
    tokens = np.asarray(result["tokens"])
    if tokens.shape != (BATCH, N_NEW) or tokens.min() < 0 or tokens.max() >= vocab:
        raise AssertionError(f"{what} served tokens: shape {tokens.shape}, "
                             f"range {tokens.min()}..{tokens.max()}")
    again = _teacher_forced_argmax(model, prompts, tokens, vocab, frames)
    differ = int((again != tokens).sum())
    if differ:
        raise AssertionError(f"{what}: {differ} served tokens differ from "
                             f"the teacher-forced decode re-run")
    return result, launches, peak, n_attn


def step_bound(model, batch: int) -> dict:
    """The least time one decode step of ``batch`` rows could take: the
    bytes it must read (every decoder parameter, the float32 head or the
    tied embedding it is, but not an untied input embedding, of which a
    step reads a row a request, nor an encoder-decoder's encoder and
    position tables; and the cached encoder output, once for the keys and
    once for the values of each cross-attention) over the memory rate,
    against its products (2 flops a parameter a row, and the
    cross-attention's keys and values of every encoder row) over the
    dense bf16 rate.  The KV cache rows, a few hundred a request, are
    left out."""
    cfg = model.cfg
    skip = ("enc.", "enc_pos", "dec_pos") + (
        ("embed",) if model.head is not None else ())
    params = [p for name, p in model.named_parameters()
              if not name.startswith(skip)]
    nbytes = sum(p.numel() * p.element_size() for p in params)
    ops = 2 * batch * sum(p.numel() for p in params)
    if cfg.enc_layers:
        kv = cfg.n_kv_heads * cfg.resolved_head_dim
        rows = batch * cfg.enc_seq
        nbytes += 2 * cfg.n_layers * rows * cfg.d_model * model.dtype.itemsize
        ops += 2 * cfg.n_layers * rows * cfg.d_model * 2 * kv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return {"step_bound_ms": max(t_bytes, t_ops),
            "step_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "step_bytes": int(nbytes), "step_ops": int(ops)}


def _serve_row(result: dict, prompts, model) -> dict:
    from repro_torch.serve_lm import BATCH, MAX_CACHE, N_NEW, serve_metrics
    return {"requests": BATCH, "prompt_lengths": [len(p) for p in prompts],
            "n_new": N_NEW, "max_cache": MAX_CACHE, **serve_metrics(result),
            "prefill_s": result["prefill_s"], "decode_s": result["decode_s"],
            "prefill_steps": result["prefill_steps"], "decode_steps": N_NEW,
            "served_tokens_held": BATCH * N_NEW,
            **step_bound(model, BATCH)}


def run_lm_family(card: str, dev, arch: str) -> dict:
    """One family at full width: (a) the float32 decode-vs-forward check at
    FAMILY_LAYERS' cut, (b) for falcon-mamba phase 6's bf16 reading at the
    served depth, (c) ``serve_lm``'s workload in bf16 at the served depth,
    each served token equal to the argmax of a teacher-forced decode_step
    re-run over the same sequence in the same batch (the decode step is
    deterministic: the MoE combine adds in a fixed order)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import CausalLM
    from repro_torch.serve_lm import SEED, workload_prompts

    t_phase = time.perf_counter()
    full = get_config(arch)
    served, checked = FAMILY_LAYERS[arch]
    moe = full.moe
    f32 = dataclasses.replace(
        full, n_layers=checked, dtype="float32",
        moe=moe and dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k))
    check = _decode_vs_forward(f32, SEED, dev, LOGPROB_LIMIT_F32)
    emit({"phase": "lm_family_decode_vs_forward", "arch": arch,
          "dtype": "float32", "layers": checked, "limit": LOGPROB_LIMIT_F32,
          "greedy_margin": 2 * LOGPROB_LIMIT_F32, **check})
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, n_layers=served)
    checks = [check]
    if moe is None:
        # read, not held: the reference's own bf16 forward and decode differ
        # here by more than LOGPROB_LIMIT (see LOGPROB_LIMIT_F32's comment)
        checks.append(_decode_vs_forward(cfg, SEED, dev, hold=False))
        emit({"phase": "lm_family_decode_vs_forward", "arch": arch,
              "dtype": cfg.dtype, "layers": served, "limit": LOGPROB_LIMIT,
              **checks[-1]})
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = CausalLM(cfg, device=dev, seed=SEED)
    init = {**_init_row(model, cfg, t0), "of_layers": full.n_layers}
    emit({"phase": "lm_family_init", **init})
    prompts = workload_prompts(cfg.vocab)
    result, launches, peak, n_attn = _serve_held(model, prompts, arch)
    row = _serve_row(result, prompts, model)
    del model
    torch.cuda.empty_cache()
    out = {"card": card, "arch": arch, "layers": served,
           "of_layers": full.n_layers, **row,
           "attn_layers": n_attn,
           "decode_attention_launches": launches["decode_attention"],
           "peak_memory_bytes": peak,
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "lm_family_serve", **out})
    print(f"lm_family {arch} ({served} of {full.n_layers} layers, "
          f"{init['weight_bytes']} weight bytes, {init['params']} params, "
          f"init {init['init_s']:.2f} s): prefill "
          f"{out['prefill_tokens_per_s']:.1f} tokens/s, decode "
          f"{out['decode_tokens_per_s']:.1f} tokens/s, median step "
          f"{out['median_step_ms']:.3f} ms, peak memory {peak} bytes, "
          f"decode_attention {launches['decode_attention']} launches, "
          f"{out['seconds']:.1f} s on {card}", flush=True)
    return {**out, "decode_vs_forward": checks, "init": init,
            "launches": launches}


def run_lm_families(card: str, dev) -> dict:
    """Phase 6b: each family of FAMILY_LAYERS in turn, the card's memory
    freed between them."""
    import torch
    out = {}
    for arch in FAMILY_LAYERS:
        out[arch] = run_lm_family(card, dev, arch)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6c: the encoder-decoder and VLM families (whisper-medium,
# llava-next-mistral-7b) at full width and depth
# ---------------------------------------------------------------------------


def run_whisper(card: str, dev) -> dict:
    """whisper-medium at full depth (24 + 24 layers): (a) float32
    teacher-forced decode_step (decode attention through the kernel,
    cross-attention over the cached encoder output) against the forward,
    held within LOGPROB_LIMIT_F32; (b) the same in bf16 within
    LOGPROB_LIMIT; (c) serve_lm's
    workload with random frames from its seed, 24 decode_attention
    launches a step, every served token held against a teacher-forced
    re-run."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import CausalLM
    from repro_torch.serve_lm import SEED, workload_frames, workload_prompts

    t_phase = time.perf_counter()
    cfg = get_config("whisper-medium")
    checks = []
    for c, limit in ((dataclasses.replace(cfg, dtype="float32"),
                      LOGPROB_LIMIT_F32), (cfg, LOGPROB_LIMIT)):
        checks.append(_decode_vs_forward(c, SEED, dev, limit))
        emit({"phase": "lm_encdec_decode_vs_forward", "arch": cfg.name,
              "dtype": c.dtype, "layers": c.n_layers,
              "enc_layers": c.enc_layers, "limit": limit, **checks[-1]})
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = CausalLM(cfg, device=dev, seed=SEED)
    init = _init_row(model, cfg, t0)
    emit({"phase": "lm_encdec_init", **init})
    prompts = workload_prompts(cfg.vocab)
    frames = workload_frames(cfg)
    result, launches, peak, n_attn = _serve_held(model, prompts, cfg.name,
                                                 frames)
    row = _serve_row(result, prompts, model)
    del model
    torch.cuda.empty_cache()
    out = {"card": card, "arch": cfg.name, **row,
           "frames": list(frames.shape), "attn_layers": n_attn,
           "decode_attention_launches": launches["decode_attention"],
           "launches_per_step": launches["decode_attention"]
           / (result["prefill_steps"] + len(result["step_s"])),
           "peak_memory_bytes": peak,
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "lm_encdec_serve", **out})
    print(f"lm_encdec {cfg.name} ({cfg.enc_layers} + {cfg.n_layers} layers, "
          f"{init['weight_bytes']} weight bytes, {init['params']} params): "
          f"float32 decode vs forward {checks[0]['max_abs_logprob_err']:.3g}, "
          f"bf16 {checks[1]['max_abs_logprob_err']:.4g}; prefill "
          f"{out['prefill_tokens_per_s']:.1f} tokens/s, decode "
          f"{out['decode_tokens_per_s']:.1f} tokens/s, median step "
          f"{out['median_step_ms']:.3f} ms, peak memory {peak} bytes, "
          f"decode_attention {launches['decode_attention']} launches "
          f"({out['launches_per_step']:.0f} a step), {out['seconds']:.1f} s "
          f"on {card}", flush=True)
    return {**out, "decode_vs_forward": checks, "init": init,
            "launches": launches}


def run_llava(card: str, dev) -> dict:
    """llava-next-mistral-7b at full depth (32 layers): (a) bf16 forward
    and prefill with a full image prefix (16 x 576 random patch rows) and
    an LLAVA_PROMPT-token prompt: finite logits, prefill equal to the
    forward's last row, the prefix's hidden states bit for bit the same
    when the text tokens change; (b) float32 decode-vs-forward on the
    text-only backbone (an empty image prefix) at LLAVA_CHECK_LAYERS
    layers within LOGPROB_LIMIT_F32; (c) serve_lm's workload over tokens
    only (the reference's decode_step), 32 decode_attention launches a
    step, every served token held against a teacher-forced re-run."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import CausalLM
    from repro_torch.serve_lm import SEED, workload_prompts

    t_phase = time.perf_counter()
    cfg = get_config("llava-next-mistral-7b")
    vocab = cfg.vocab
    t0 = time.perf_counter()
    model = CausalLM(cfg, device=dev, seed=SEED)
    init = _init_row(model, cfg, t0)
    emit({"phase": "lm_vlm_init", **init})

    # (a) the image prefix
    n_img = cfg.n_img_tiles * cfg.img_patches
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.standard_normal((1, n_img, cfg.d_model),
                                               np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(0, vocab, (1, LLAVA_PROMPT))).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden = model.forward(toks, img_embeds=img)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        last = model.logits_fn(hidden[:, -1:])
        finite = bool(torch.isfinite(model.logits_fn(hidden)[..., :vocab]).all())
        t0 = time.perf_counter()
        pre = model.prefill(toks, img_embeds=img)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        other = model.forward((toks + 1) % vocab, img_embeds=img)
    peak = torch.cuda.max_memory_allocated(dev)
    if hidden.shape != (1, n_img + LLAVA_PROMPT, cfg.d_model) or not finite:
        raise AssertionError(f"{cfg.name}: forward {tuple(hidden.shape)}, "
                             f"finite logits {finite}")
    if not torch.equal(pre, last):
        raise AssertionError(f"{cfg.name}: prefill is "
                             f"{float((pre - last).abs().max()):.3g} off the "
                             f"forward's last row")
    if not torch.equal(hidden[:, :n_img], other[:, :n_img]):
        raise AssertionError(f"{cfg.name}: the image rows' hidden states "
                             f"moved with the text tokens")
    if torch.equal(hidden[:, n_img:], other[:, n_img:]):
        raise AssertionError(f"{cfg.name}: the text rows did not move")
    prefix = {"image_rows": n_img, "prompt_tokens": LLAVA_PROMPT,
              "forward_s": forward_s, "prefill_s": prefill_s,
              "peak_memory_bytes": peak}
    emit({"phase": "lm_vlm_prefix", "arch": cfg.name, **prefix})
    del hidden, other, pre, last

    # (c) serving, tokens only
    prompts = workload_prompts(vocab)
    result, launches, serve_peak, n_attn = _serve_held(model, prompts,
                                                       cfg.name)
    row = _serve_row(result, prompts, model)
    del model
    torch.cuda.empty_cache()

    # (b) float32 decode vs forward, text-only backbone, cut depth
    f32 = dataclasses.replace(cfg, n_layers=LLAVA_CHECK_LAYERS, dtype="float32")
    check = _decode_vs_forward(f32, SEED, dev, LOGPROB_LIMIT_F32)
    emit({"phase": "lm_vlm_decode_vs_forward", "arch": cfg.name,
          "dtype": "float32", "layers": LLAVA_CHECK_LAYERS,
          "limit": LOGPROB_LIMIT_F32, **check})
    torch.cuda.empty_cache()
    out = {"card": card, "arch": cfg.name, **row,
           "attn_layers": n_attn,
           "decode_attention_launches": launches["decode_attention"],
           "launches_per_step": launches["decode_attention"]
           / (result["prefill_steps"] + len(result["step_s"])),
           "peak_memory_bytes": serve_peak,
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "lm_vlm_serve", **out})
    print(f"lm_vlm {cfg.name} ({cfg.n_layers} layers, {init['weight_bytes']} "
          f"weight bytes): forward of {n_img} image rows + {LLAVA_PROMPT} "
          f"tokens {forward_s:.3f} s, prefill {prefill_s:.3f} s, peak "
          f"{peak} bytes; float32 decode vs forward "
          f"{check['max_abs_logprob_err']:.3g} ({LLAVA_CHECK_LAYERS} layers); "
          f"serve: decode {out['decode_tokens_per_s']:.1f} tokens/s, median "
          f"step {out['median_step_ms']:.3f} ms, decode_attention "
          f"{launches['decode_attention']} launches "
          f"({out['launches_per_step']:.0f} a step), {out['seconds']:.1f} s "
          f"on {card}", flush=True)
    return {**out, "prefix": prefix, "decode_vs_forward": [check],
            "init": init, "launches": launches}


def run_lm_encdec(card: str, dev) -> dict:
    """Phase 6c: whisper-medium, then llava-next-mistral-7b, the card's
    memory freed between them."""
    import torch
    out = {"whisper-medium": run_whisper(card, dev)}
    torch.cuda.empty_cache()
    out["llava-next-mistral-7b"] = run_llava(card, dev)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6d: the train step
# ---------------------------------------------------------------------------


def run_training(card: str, dev) -> dict:
    """Phase 6d: (a) train_lm's reference workload; (b) llama3.2-3b at full
    width and depth, bf16 compute with float32 masters and moments,
    TRAIN_FULL steps on one repeated batch: finite, falling loss and a
    finite gradient norm; (c) one float32 step of llama3.2-3b at full width
    with TRAIN_CHECK_LAYERS layers, on the card (TF32 off) against the CPU
    from the same masters, within TRAIN_CPU_LIMITS."""
    import dataclasses
    import math
    import torch
    from repro_torch import train_lm
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.serve_lm import SEED
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    out = {"card": card}
    t_phase = time.perf_counter()
    build.reset_launch_counts()

    # (a) the reference example's workload
    ex = train_lm.run(device=dev, log=lambda *_: None)
    losses = ex.pop("losses")
    ex["loss_every_20"] = losses[::20] + [losses[-1]]
    if not ex["improved"] or ex["checkpoint_max_abs_diff"] != 0:
        raise AssertionError(f"train_lm: loss {ex['first_loss']:.4f} → "
                             f"{ex['last_loss']:.4f}, checkpoint max |delta| "
                             f"{ex['checkpoint_max_abs_diff']}")
    out["train_lm"] = ex
    emit({"phase": "train_lm", **ex})
    torch.cuda.empty_cache()

    # (b) llama3.2-3b at full width and depth, bf16 with float32 masters
    cfg = get_config("llama3.2-3b")
    batch_n, seq, n_steps = TRAIN_FULL
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(cfg, device=dev, seed=SEED)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=n_steps), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = next(train_lm.synthetic_stream(cfg.vocab, batch_n, seq, seed=SEED,
                                           device=dev))
    rows = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        rows.append({"loss": loss, "grad_norm": gnorm,
                     "seconds": time.perf_counter() - t0})
    peak = torch.cuda.max_memory_allocated(dev)
    full = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch_n,
            "tokens": seq, "steps": rows, "init_s": init_s,
            "ln_vocab": math.log(cfg.vocab), "peak_memory_bytes": peak,
            "params": sum(p.numel() for p in state["params"].values())}
    del state, step, batch, metrics
    torch.cuda.empty_cache()
    if not (all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in rows) and rows[-1]["loss"] < rows[0]["loss"]):
        raise AssertionError(f"{cfg.name} train steps: {rows}")
    out["llama_full"] = full
    emit({"phase": "train_full_width", **full})

    # (c) one float32 step, card against the CPU, from the same masters
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c32 = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS, dtype="float32")
    opt = OptConfig(warmup_steps=1, total_steps=10)
    cpu_state = init_train_state(c32, device="cpu", seed=SEED)
    b = next(train_lm.synthetic_stream(c32.vocab, *TRAIN_CHECK, seed=SEED))
    got = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        st = {"params": {k: v.to(device, copy=True)
                         for k, v in cpu_state["params"].items()}}
        st["opt"] = {"mu": {k: torch.zeros_like(v) for k, v in st["params"].items()},
                     "nu": {k: torch.zeros_like(v) for k, v in st["params"].items()},
                     "step": torch.zeros((), dtype=torch.int32, device=device)}
        fn = make_train_step(c32, opt, device=device)
        _, metrics = fn(st, {k: v.to(device) for k, v in b.items()},
                        keep_grads=True)
        got[name] = {"loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "grads": {k: g.cpu() for k, g in metrics["grads"].items()},
                     "seconds": time.perf_counter() - t0}
        del st, fn, metrics
        torch.cuda.empty_cache()
    readings = {key: abs(got["card"][key] - got["cpu"][key]) / abs(got["cpu"][key])
                for key in ("loss", "grad_norm")}
    leaf = {k: float((got["card"]["grads"][k] - g).norm() / g.norm())
            for k, g in got["cpu"]["grads"].items() if float(g.norm()) > 0}
    readings["grad_leaf"] = max(leaf.values())
    check = {"arch": cfg.name, "layers": TRAIN_CHECK_LAYERS,
             "batch": TRAIN_CHECK[0], "tokens": TRAIN_CHECK[1],
             "loss": got["cpu"]["loss"], "grad_norm": got["cpu"]["grad_norm"],
             "card_s": got["card"]["seconds"], "cpu_s": got["cpu"]["seconds"],
             "readings": readings, "limits": TRAIN_CPU_LIMITS,
             "worst_leaf": max(leaf, key=leaf.get)}
    out["card_vs_cpu"] = check
    emit({"phase": "train_card_vs_cpu", **check})
    over = {k: v for k, v in readings.items() if not v <= TRAIN_CPU_LIMITS[k]}
    if over:
        raise AssertionError(f"train step, card against CPU: {over} over "
                             f"{TRAIN_CPU_LIMITS}")
    out["launches"] = build.launch_counts()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"train: train_lm {ex['first_loss']:.3f} → {ex['last_loss']:.3f} at "
          f"{ex['steps_per_s']:.2f} steps/s; {cfg.name} full width, "
          f"{batch_n} x {seq} tokens: loss {rows[0]['loss']:.4f} → "
          f"{rows[-1]['loss']:.4f} (ln vocab {full['ln_vocab']:.4f}), step "
          f"{statistics.median(r['seconds'] for r in rows):.3f} s, peak "
          f"{peak} bytes; float32 card vs CPU {readings}; "
          f"{out['seconds']:.1f} s on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6e: the model half of launch/ (dry run, then shard programs for real)
# ---------------------------------------------------------------------------


def _model_dry_line(arch: str, shape: str, rec: dict) -> dict:
    mem = rec["memory"]
    return {"arch": arch, "shape": shape, "mesh": "16x16",
            "flops": rec["flops_per_device"],
            "dot_flops": rec["flops_detail"]["dot_flops_loop_corrected"],
            "bytes_accessed": rec["bytes_accessed_per_device"],
            "collective_bytes": rec["collective_bytes_per_device"],
            "argument_bytes": mem["argument_bytes"],
            "resident_bytes": mem["resident_bytes_per_chip"],
            "fits_card": mem["fits_card"], "padded": rec["padded"],
            "run_s": rec["run_time_s"]}


def run_model_launch(card: str, dev) -> dict:
    """Phase 6e: the model cells' dry run on this machine against the CPU
    sweep's counts, then llama3.2-3b's train and prefill shard programs on
    the card against their predicted peak."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, model_dryrun
    from repro_torch.serve_lm import SEED

    t_phase = time.perf_counter()
    build.reset_launch_counts()
    golden = json.loads((ROOT / MODEL_DRY_GOLDEN).read_text())
    release = torch.__version__.split("+")[0]
    same = release == golden["torch"]
    dry = {}
    for arch, shape in MODEL_DRY_CELLS:
        rec = dryrun.model_record(arch, shape, False)
        dry[(arch, shape)] = rec
        got = json.loads(json.dumps(model_dryrun.counts(rec)))
        want = golden["cells"][f"{arch} {shape}"]
        emit({"phase": "model_dry", "card": card, "torch": release,
              "golden_torch": golden["torch"],
              **_model_dry_line(arch, shape, rec),
              "bytes_accessed_over_cpu": got["bytes_accessed_per_device"]
              / want["bytes_accessed_per_device"]})
        diff = model_dryrun.counts_differ(got, want, same)
        if diff:
            raise AssertionError(f"dry run {arch} {shape}: counts differ "
                                 f"from the CPU sweep's: {diff}")
    runs = []
    for arch, shape in MODEL_REAL_CELLS:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _, _, cell = dryrun.lower_cell(arch, shape, False, device=dev,
                                       sample=False, seed=SEED)
        out = cell.run(None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        finite = bool(all(torch.isfinite(x).all() for x in
                          (out if isinstance(out, tuple) else (out,))))
        del out, cell
        predicted = dry.get((arch, shape)) or dryrun.model_record(
            arch, shape, False)
        pred = predicted["memory"]["resident_bytes_per_chip"]
        row = {"arch": arch, "shape": shape, "mesh": "16x16",
               "peak_bytes": peak, "predicted_peak_bytes": pred,
               "peak_over_predicted": peak / pred, "seconds": seconds,
               "finite": finite}
        runs.append(row)
        emit({"phase": "model_run", "card": card, **row})
        if abs(peak / pred - 1) > MODEL_PEAK_RTOL:
            raise AssertionError(f"{arch} {shape}: peak {peak} against the "
                                 f"predicted {pred} ({peak / pred:.3f})")
        if not finite:
            raise AssertionError(f"{arch} {shape}: non-finite outputs")
    torch.cuda.empty_cache()
    counts = build.launch_counts()
    result = {"dry": [_model_dry_line(a, s, r) for (a, s), r in dry.items()],
              "runs": runs,
              "launches": {k: counts.get(k, 0) for k in REPLACES},
              "seconds": time.perf_counter() - t_phase}
    emit({"phase": "model_launch", "card": card,
          "seconds": result["seconds"], "launches": result["launches"]})
    return result


def _captured(name: str, fn, *args, **kw) -> tuple:
    """Run ``fn`` with its printed text sent to ``build/chip_smoke_<name>.txt``
    → (its result, its ms)."""
    import contextlib
    import io
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(*args, **kw)
    finally:
        (ROOT / "build").mkdir(exist_ok=True)
        (ROOT / "build" / f"chip_smoke_{name}.txt").write_text(buf.getvalue())
    return out, (time.perf_counter() - t) * 1e3


def _margin(a: float, b: float, frac: float, slack: float) -> float:
    """|a - b| over the trace report's tolerance: at most 1 passes."""
    return abs(a - b) / (frac * max(a, b) + slack)


def run_examples(card: str, dev) -> dict:
    """Phase 7: the quickstart, the distributed example and the trace
    report, each through its entry point on the card (module docstring)."""
    from repro_torch import distributed_query, quickstart, trace_report
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.data.tpch import generate, load_into_engine
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    build.reset_launch_counts()
    qs, qs_ms = _captured("quickstart", quickstart.main, device=dev)
    qs_launches = build.launch_counts()
    eager = SiriusEngine(compile_pipelines=False, device=dev)
    load_into_engine(eager, generate(quickstart.SF))
    rows = {k: np.array([r[k] for r in qs["rows"]]) for k in qs["rows"][0]}
    sql_err = compare_tables(rows, eager.sql(quickstart.SQL).to_host())
    want = eager.execute(quickstart.revenue_plan()).to_host()["revenue"]
    np.testing.assert_allclose(qs["revenues"], want, rtol=1e-6, atol=1e-6)
    if not qs["q3_same"]:
        raise AssertionError("quickstart: Q3's SQL path differs from its plan")
    if qs["hits"] != QUICKSTART_HITS:
        raise AssertionError(f"quickstart hits {qs['hits']} != {QUICKSTART_HITS}")
    if (qs["fallback"]["route"], qs["fallback"]["s"]) != ("fallback", 6.0):
        raise AssertionError(f"quickstart fallback {qs['fallback']}")
    missing = [k for k in ("filter_mask_counts", "hash_probe", "groupby_sum")
               if not qs_launches[k]]
    if missing:
        raise AssertionError(f"quickstart launched no {missing}")
    del eager

    dq, dq_ms = _captured("distributed_query", distributed_query.main,
                          device=dev)
    got_rows = {q: r["rows"] for q, r in dq["queries"].items()}
    if got_rows != EXAMPLE_ROWS:
        raise AssertionError(f"distributed_query rows {got_rows}")
    rec = dq["recovered"]
    np.testing.assert_allclose(rec["revenue"], rec["want"], rtol=1e-6)
    if (rec["recoveries"], rec["live_nodes"]) != (0, list(range(8))):
        raise AssertionError(f"distributed_query recovery {rec}")

    tr, tr_ms = _captured("trace_report", trace_report.run, [
        "--shards", "4", "--qid", "3", "--device", str(dev),
        "--chrome", str(ROOT / "build" / "chip_smoke_trace_report.json")])
    if tr["code"] != 0:
        raise AssertionError(f"trace_report failed: {tr['failures']}")
    tol = (trace_report.TOLERANCE_FRAC, trace_report.TOLERANCE_S)
    counts = build.launch_counts()
    result = {
        "quickstart": {"ms": qs_ms, "sql_max_rel_err": sql_err[0],
                       "wire_bytes": qs["wire_bytes"],
                       "compiler": qs["compiler"], "hits": qs["hits"],
                       "fallback": qs["fallback"],
                       "q6_cold_ms": qs["q6_cold_ms"],
                       "q6_hot_ms": qs["q6_hot_ms"]},
        "distributed_query": {
            "ms": dq_ms, "rows": got_rows,
            "timers_ms": {q: {k: r["timers"].get(k, 0.0) * 1e3
                              for k in ("compute", "exchange", "other")}
                          for q, r in dq["queries"].items()},
            "recoveries": rec["recoveries"], "live_nodes": rec["live_nodes"]},
        "trace_report": {
            "ms": tr_ms, "root_ms": tr["root_s"] * 1e3,
            "total_ms": tr["total_s"] * 1e3, "span_ms": tr["span_s"] * 1e3,
            "profile_ms": tr["profile_s"] * 1e3,
            "root_margin": _margin(tr["root_s"], tr["total_s"], *tol),
            "span_margin": _margin(tr["span_s"], tr["profile_s"], *tol)},
        "launches": {k: counts.get(k, 0) for k in REPLACES},
        "seconds": time.perf_counter() - t_phase}
    for part in ("quickstart", "distributed_query", "trace_report"):
        emit({"phase": f"examples_{part}", "card": card, **result[part]})
    emit({"phase": "examples", "card": card, "seconds": result["seconds"],
          "launches": result["launches"]})
    return result


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

    seconds = report["phase_seconds"] = {"build": report["build"]["seconds"]}

    def phase(name: str, fn, *args):
        """Run one phase, record and print its seconds."""
        t = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return result

    t3 = time.perf_counter()
    kernels = []
    for check in PHASE3:
        row = run_check(check)
        emit({"phase": "kernel", **row})
        kernels.append(row)
    seconds["3_kernels"] = time.perf_counter() - t3
    print(f"phase 3_kernels: {seconds['3_kernels']:.1f} s", flush=True)

    report["main_path"], tables, tpch_db = phase("4_tpch", run_main_path)
    report["compiled_path"] = phase("4b_compiled", run_compiled_path, tables)
    report["clickbench"], cb_table, cb_db = phase("5_clickbench",
                                                  run_clickbench)
    report["front_door"] = phase(
        "5b_front_door", run_front_door, card, tables, tpch_db, cb_table,
        cb_db, report["compiled_path"].pop("sql_runs"))
    report["analyze"] = phase("5c_analyze", run_analyze, card, tables,
                              tpch_db, cb_table, cb_db)
    report["distributed"] = phase("5d_distributed", run_distributed, card,
                                  dev, tables, tpch_db, cb_table, cb_db)
    del tables, tpch_db, cb_table, cb_db
    torch.cuda.empty_cache()
    report["launch"] = phase("5e_launch", run_launch, card, dev)
    torch.cuda.empty_cache()
    report["lm_serve"] = phase("6_lm_serve", run_lm_serve, card, dev)
    torch.cuda.empty_cache()
    report["lm_families"] = phase("6b_lm_families", run_lm_families, card,
                                  dev)
    torch.cuda.empty_cache()
    report["lm_encdec"] = phase("6c_lm_encdec", run_lm_encdec, card, dev)
    torch.cuda.empty_cache()
    report["training"] = phase("6d_training", run_training, card, dev)
    torch.cuda.empty_cache()
    report["model_launch"] = phase("6e_model_launch", run_model_launch, card,
                                   dev)
    torch.cuda.empty_cache()
    report["examples"] = phase("7_examples", run_examples, card, dev)
    seconds["total"] = time.perf_counter() - T_START
    emit({"phase": "seconds", **seconds})
    by_path = {"tpch": report["main_path"]["launches"],
               "tpch_compiled": report["compiled_path"]["launches"],
               "clickbench": report["clickbench"]["launches"],
               "front_door": report["front_door"]["launches"],
               "analyze": report["analyze"]["launches"],
               "distributed": report["distributed"]["launches"],
               "sql_fragments": report["launch"]["launches"],
               "lm_serve": report["lm_serve"]["launches"],
               **{f"lm_serve/{arch}": r["launches"]
                  for arch, r in report["lm_families"].items()},
               **{f"lm_serve/{arch}": r["launches"]
                  for arch, r in report["lm_encdec"].items()},
               "training": report["training"]["launches"],
               "model_launch": report["model_launch"]["launches"],
               "examples": report["examples"]["launches"]}
    line = []
    for row in kernels:
        name = row["name"]
        line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "device_ms": row["device_ms"],
            "grids_per_call": row["grids_per_call"],
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
    print(card, flush=True)
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
