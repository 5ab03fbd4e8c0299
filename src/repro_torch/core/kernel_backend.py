"""Operator backend that routes eligible operators to the CUDA kernels.

Counterpart of ``repro/core/kernel_backend.py``, with the same eligibility
rules.  The executor consults this backend first; when an operator matches
a kernel's contract it runs on the kernel, otherwise it falls through to the
generic torch implementation.  Enabled via ``SiriusEngine(use_kernels=True)``.
On CPU tensors each kernel wrapper runs its plain version instead.

  * filter    — conjunction of closed/open range predicates over numeric/date
                columns → ``filter_mask_counts``.
  * probe     — single-column integer PK-FK inner/semi/anti/mark join →
                int32-factorized open-addressing ``hash_probe``.
  * aggregate — group-by with int-factorizable keys and sum/count/avg/min/max
                and count distinct of integer-coded values → ``groupby_sum``
                for the additive aggregates, ``count_distinct`` for the
                distinct counts, device segment ops for min/max.
  * expand    — the eager join's run expansion (multi-match inner/left) →
                ``join_expand``.
  * topk      — ORDER BY + LIMIT over integer/date/string-code keys packed
                into one composite rank, float32 where it is exact and
                int64 where it is wider → ``topk_select``.

Numerical note for the aggregate path: the kernel sums float32, so each
additive column is centered by its f64 mean (the sums carry deviations, not
magnitudes) and split into an f32 hi/lo pair whose f64 sum reproduces the
centered value exactly (sum = kernel_sum(hi) + kernel_sum(lo) + c·count).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..observability.journal import JOURNAL
from ..observability.metrics import METRICS
from ..relational.aggregate import AggSpec, factorize_groups, segment_reduce
from ..relational.expressions import Between, BinOp, Col, Expr, Lit, evaluate
from ..relational.table import BOOL, DATE, NUMERIC, STRING, Column, Table, dtype_kind
from .instrument import pull_scalar


def _collect_range_conjuncts(e: Expr, out: List[Tuple[str, float, float]]) -> bool:
    """Flatten an AND tree of range predicates; False if any leaf is foreign."""
    if isinstance(e, BinOp) and e.op == "and":
        return (_collect_range_conjuncts(e.left, out)
                and _collect_range_conjuncts(e.right, out))
    if isinstance(e, Between) and isinstance(e.operand, Col) \
            and isinstance(e.lo, Lit) and isinstance(e.hi, Lit):
        out.append((e.operand.name, float(e.lo.value), float(e.hi.value)))
        return True
    if isinstance(e, BinOp) and isinstance(e.left, Col) and isinstance(e.right, Lit):
        v = e.right.value
        if isinstance(v, str):
            return False
        v = float(v)
        if e.right.kind == DATE:   # int day counts: exact ±1 steps
            below = v - 1.0
            above = v + 1.0
        else:                      # f32 lattice neighbours for strict bounds
            below = float(np.nextafter(np.float32(v), np.float32(-np.inf)))
            above = float(np.nextafter(np.float32(v), np.float32(np.inf)))
        if e.op == "<":
            out.append((e.left.name, -np.inf, below))
        elif e.op == "<=":
            out.append((e.left.name, -np.inf, v))
        elif e.op == ">":
            out.append((e.left.name, above, np.inf))
        elif e.op == ">=":
            out.append((e.left.name, v, np.inf))
        elif e.op == "==":
            out.append((e.left.name, v, v))
        else:
            return False
        return True
    return False


_SUM_FNS = ("sum", "count", "count_star", "avg")
_AGG_FNS = _SUM_FNS + ("min", "max", "count_distinct")
# a group's float32 count in ``groupby_sum`` is exact up to 2^24 rows: a
# group-by over more rows runs the kernel on chunks of this many
ROW_BOUND = 2**24
# a composite ORDER BY rank spanning at most this many values is exact in
# float32; a wider one that fits in 63 bits goes to the kernel as int64
F32_RANKS = 2**24


class KernelBackend:
    """Tracks usage so tests/benchmarks can assert the kernel path fired."""

    def __init__(self):
        self.filter_hits = 0
        self.probe_hits = 0
        self.agg_hits = 0
        self.expand_hits = 0
        self.topk_hits = 0

    def hit_counts(self) -> dict:
        return dict(filter=self.filter_hits, probe=self.probe_hits,
                    agg=self.agg_hits, expand=self.expand_hits,
                    topk=self.topk_hits)

    # -- fused range filter ---------------------------------------------------
    def try_filter(self, cond: Expr, t: Table) -> Optional[Table]:
        conjuncts: List[Tuple[str, float, float]] = []
        if not _collect_range_conjuncts(cond, conjuncts) or not conjuncts:
            return None
        cols = []
        for name, _, _ in conjuncts:
            if name not in t:
                return None
            c = t[name]
            if c.kind not in (NUMERIC, DATE):
                return None
            if t.num_rows:
                # f32 lanes: only exact below 2^24 — device-side reduction,
                # scalar pull only (never a column copy to host)
                if pull_scalar(c.data.abs().max()) >= 2**24:
                    return None
            cols.append(c.data.to(torch.float32))
        device = t.device
        mat = torch.stack(cols, dim=1)
        lo = torch.tensor([c[1] for c in conjuncts], dtype=torch.float32,
                          device=device)
        hi = torch.tensor([c[2] for c in conjuncts], dtype=torch.float32,
                          device=device)
        idx, count = kops.filter_select(mat, lo, hi)
        self.filter_hits += 1
        METRICS.counter("kernel.filter_hits").inc()
        return t.take(idx[: pull_scalar(count)])

    # -- hash-probe join --------------------------------------------------------
    def try_probe(self, probe: Table, build: Table, probe_keys, build_keys,
                  how: str) -> Optional[Table]:
        if len(probe_keys) != 1 or how not in ("inner", "semi", "anti", "mark"):
            return None
        pc, bc = probe[probe_keys[0]], build[build_keys[0]]
        if pc.kind != NUMERIC or bc.kind != NUMERIC:
            return None
        bk, pk = bc.data, pc.data
        if dtype_kind(bk) not in "iu" or dtype_kind(pk) not in "iu":
            return None
        if bk.shape[0] == 0 or pk.shape[0] == 0:
            return None
        bk = bk.to(torch.int64)
        n = bk.shape[0]
        # device-side build: the sorted ranks double as the int32
        # factorization and as the uniqueness check
        nb = kops.bucket_size(n)
        valid = torch.arange(nb, device=bk.device) < n
        s, _, ranks, dup, sentinel_hit = kops.sorted_build(
            kops.pad_rows(bk, nb), valid)
        if pull_scalar(dup) or pull_scalar(sentinel_hit):
            return None
        b32 = torch.where(valid, ranks, -1).to(torch.int32)
        sk, sr, placed = kops.build_table32(b32, valid)
        if not pull_scalar(placed):
            return None
        p32 = kops.map_probe_keys(s, pk.to(torch.int64))
        row, found = kops.hash_probe(p32, sk, sr)
        self.probe_hits += 1
        METRICS.counter("kernel.probe_hits").inc()
        if how == "mark":
            return probe.with_column("__mark", Column(found, BOOL))
        if how == "semi":
            sel, k = kops.compact(found)
            return probe.take(sel[: pull_scalar(k)])
        if how == "anti":
            sel, k = kops.compact(~found)
            return probe.take(sel[: pull_scalar(k)])
        # inner: gather matched probe rows + matched build rows
        sel, k = kops.compact(found)
        sel = sel[: pull_scalar(k)]
        out = {nm: c.take(sel) for nm, c in probe.columns.items()}
        bidx = row[sel]
        for nm, c in build.columns.items():
            if nm not in out:
                out[nm] = c.take(bidx)
        return Table(out)

    # -- group-by aggregation ----------------------------------------------------
    def try_aggregate(self, t: Table, keys: Sequence[str],
                      aggs: Sequence[AggSpec]) -> Optional[Table]:
        """Route an eligible group-by to the ``groupby_sum`` and
        ``count_distinct`` kernels.

        Additive aggregates (sum/count/avg) become columns of one (N, V)
        value matrix summed per group in one ``groupby_sum_large`` call
        (one a chunk of ROW_BOUND rows past that bound), run only where
        one is asked for; each count distinct of an integer, date, bool or
        dictionary-coded string column is one ``count_distinct`` call in
        the journal's ``agg.count_distinct`` span; min/max ride along as
        device segment ops.  Returns None (caller falls back to the
        generic path) if any key or aggregate is outside the contract
        (a float's count distinct: -0.0 and NaN equality is not bit
        equality); all checks are metadata-level.
        """
        if t.num_rows == 0:
            return None
        for k in keys:
            if k not in t or dtype_kind(t[k].data) not in "iub":
                return None       # int-factorizable keys only (codes/dates/ints)
        if not aggs or any(a.fn not in _AGG_FNS for a in aggs):
            return None

        values: List[Optional[Column]] = []
        for a in aggs:
            if a.fn == "count_star":
                values.append(None)
                continue
            col = evaluate(a.expr, t)
            if a.fn in _SUM_FNS and (col.kind == STRING
                                     or dtype_kind(col.data) not in "ifb"):
                return None
            if a.fn == "count_distinct" and dtype_kind(col.data) not in "iub":
                return None
            values.append(col)

        gids, uniq = factorize_groups(t, keys)
        n_groups = uniq.num_rows if keys else 1

        # (N, V) value matrix: ones column (counts) + centered additive
        # columns split into hi/lo f32 pairs (v - c == hi + lo exactly to
        # ~2^-46 relative).  Centering constants stay on device (f64
        # scalars).  The centre is the mean rounded to an integer (the
        # reference takes the mean itself): an integer-valued column then
        # centres to small integers whose group sums the f32 outputs hold
        # exactly, so a HAVING on such a sum (Q18's sum(l_quantity) > 300)
        # sees the exact value
        centers = []                     # per additive agg: (data, center)
        routes = []                      # per agg: its index in centers
        for a, col in zip(aggs, values):
            if a.fn in ("sum", "avg"):
                data = col.data.to(torch.float64)
                centers.append((data, torch.round(data.mean())))
                routes.append(len(centers) - 1)
            else:
                routes.append(None)      # counts column or min/max

        # group-count bucketing, as the reference does for its compiled kernel
        g_call = max(128, 1 << (n_groups - 1).bit_length())
        gids32 = gids.to(torch.int32)
        n = t.num_rows

        def sums(cols, ones: bool):
            """Per-group sums of each (data, centre) of ``cols`` (a centre
            is a scalar or one per row) → (int64 counts where ``ones``,
            (G, len(cols)) float64 centred sums, the largest |float32
            output| of each column's hi and lo sums).  Past ROW_BOUND rows
            the kernel runs on chunks of ROW_BOUND rows: each chunk's f32
            counts are exact, and the chunks' counts add up in int64,
            their hi/lo sums in float64."""
            acc = n_rows = peak = None
            for lo in range(0, n, ROW_BOUND):
                hi = min(lo + ROW_BOUND, n)
                mat = [torch.ones(hi - lo, dtype=torch.float32,
                                  device=t.device)] if ones else []
                for data, c in cols:
                    centered = data[lo:hi] - (c if c.dim() == 0 else c[lo:hi])
                    h = centered.to(torch.float32)
                    mat += [h, (centered - h.to(torch.float64)).to(torch.float32)]
                part = kops.groupby_sum_large(gids32[lo:hi], torch.stack(mat, 1),
                                              g_call)[:n_groups]
                if n > ROW_BOUND:
                    METRICS.counter("kernel.groupby_row_chunks").inc()
                if ones:
                    c = torch.round(part[:, 0]).to(torch.int64)
                    n_rows = c if n_rows is None else n_rows.add_(c)
                    part = part[:, 1:]
                top = part.abs().amax(0).reshape(-1, 2).amax(1)
                peak = top if peak is None else torch.maximum(peak, top)
                part = part.to(torch.float64).reshape(n_groups, -1, 2).sum(2)
                acc = part if acc is None else acc.add_(part)
            return n_rows, acc, peak

        if any(a.fn in _SUM_FNS for a in aggs):
            n_rows, acc, peak = sums(centers, ones=True)
            counts = n_rows.to(torch.float64)
            totals = [acc[:, i] + c * counts
                      for i, (_, c) in enumerate(centers)]

            # float32 outputs hold integers only up to 2^24: where a
            # group's sum of an integer column about the column's centre
            # passes that (a large group whose mean lies far from it:
            # ClickBench q30's avg(ResolutionWidth)), sum again about each
            # group's own mean, whose centred sums stay small
            exact = [i for a, col, i in zip(aggs, values, routes)
                     if i is not None and dtype_kind(col.data) in "ib"]
            if n_groups > 1 and exact and pull_scalar(
                    (peak[exact] >= 2**24).any()):
                own = [torch.round(totals[i] / torch.clamp(counts, min=1.0))
                       for i in exact]
                _, again, _ = sums([(centers[i][0], c[gids]) for i, c in
                                    zip(exact, own)], ones=False)
                for j, (i, c) in enumerate(zip(exact, own)):
                    totals[i] = again[:, j] + c * counts

        out = dict(uniq.columns)
        for a, col, i in zip(aggs, values, routes):
            if a.fn == "count_distinct":
                with JOURNAL.span("agg.count_distinct", "operator"):
                    res = kops.count_distinct(
                        gids32, col.data.to(torch.int64).contiguous(),
                        n_groups)
                out[a.name] = Column(res, NUMERIC)
            elif a.fn in ("count", "count_star"):
                out[a.name] = Column(n_rows, NUMERIC)
            elif a.fn in ("sum", "avg"):
                s = totals[i]
                if a.fn == "avg":
                    out[a.name] = Column(s / torch.clamp(counts, min=1.0), NUMERIC)
                elif dtype_kind(col.data) in "ib":
                    out[a.name] = Column(torch.round(s).to(torch.int64), NUMERIC)
                else:
                    out[a.name] = Column(s, NUMERIC)
            else:                        # min / max: device segment ops
                res = segment_reduce(a.fn, col.data, gids, n_groups)
                out[a.name] = Column(res, col.kind,
                                     col.dictionary if col.kind == STRING else None)
        self.agg_hits += 1
        METRICS.counter("kernel.agg_hits").inc()
        return Table(out)

    # -- join run expansion ----------------------------------------------------
    def try_expand(self, order, lo, counts, counts_out, total: int):
        """Route the eager join's run expansion to the ``join_expand`` kernel.

        The contract is shape-level only (int32-addressable rows and
        outputs), so every multi-match inner/left join is eligible."""
        if total >= 2**31 or lo.shape[0] >= 2**31 or order.shape[0] >= 2**31:
            return None
        out = kops.join_expand(order, lo, counts, counts_out, total)
        self.expand_hits += 1
        METRICS.counter("kernel.expand_hits").inc()
        return out

    # -- top-k for ORDER BY + LIMIT --------------------------------------------
    def try_topk(self, t: Table, keys, limit) -> Optional[Table]:
        """Route an eligible ORDER BY + LIMIT to the ``topk_select`` kernel.

        Contract: integer-coded sort keys (numeric ints, dates, or string
        dictionary codes — order-preserving) packed into one composite rank
        that spans at most 2^63 values, and 0 < limit <= 128.  A rank that
        spans at most 2^24 values goes to the kernel in float32, where it
        is exact; a wider one as int64.  The kernel is tie-stable, so
        results are row-exact against the generic lexsort.  Per-key min
        and max are read with ``pull_scalar``.
        """
        if limit is None or not (0 < limit <= 128) or not keys:
            return None
        if any(k.name not in t for k in keys):
            return None
        if t.num_rows <= limit:
            return None
        bounds = []
        total = 1
        for k in keys:
            c = t[k.name]
            if dtype_kind(c.data) not in "iu":
                return None
            lo = int(pull_scalar(c.data.min()))
            hi = int(pull_scalar(c.data.max()))
            bounds.append((c.data, lo, hi - lo + 1, k.ascending))
            total *= hi - lo + 1
            if total > 2**63:      # the composite must fit in int64
                return None
        wide = total > F32_RANKS
        comp = None
        for data, lo, span, ascending in bounds:
            v = (data.to(torch.int64) if wide else data) - lo
            if not ascending:
                v = (span - 1) - v
            comp = v if comp is None else comp * span + v
        idx = kops.topk_select(comp if wide else comp.to(torch.float32), limit)
        self.topk_hits += 1
        METRICS.counter("kernel.topk_hits").inc()
        return t.take(idx)
