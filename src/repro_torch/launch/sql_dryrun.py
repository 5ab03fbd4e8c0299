"""SQL-engine fragments: the paper's own scale-out workload on a production
mesh — counterpart of ``repro/launch/sql_dryrun.py``.

Whole TPC-H SF100 distributed fragments — scan → filter → (semi join) →
shuffle → join → aggregate → top-k — each one function over a
``ShardMesh`` (the mesh is an argument; there is no ``shard_map``).
Single-pod: a flat 256-shard ``data`` mesh; multi-pod: 2 pods x 256, with
the pod-aware hierarchical shuffle.

Every input is sharded: ``(n_shards, cap)``, shard ``s`` holding its own
``cap`` rows, padded with ``valid = False``.  The declared dtypes are the
fragment's contract: money float32, keys int64, dates int32 days; the
compress variant narrows keys to int32, the discount to uint8 codes of
hundredths and the small codes to int8.

The ``build_*`` functions take ``sf=`` and ``mesh=``, which default to the reference's
SF100 on 256 (or 2 x 256) shards, so that the same body runs smaller; the
sizing rules are the reference's (``_caps``, a slack of 2, a
predicate-transfer selectivity of 0.15).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.static_ops import (
    local_sort_agg, shard_segment_sum, static_inner_join, static_semi_join,
    static_topk,
)
from ..exchange.bloom import bloom_build, bloom_maybe_contains, bloom_or_across
from ..exchange.service import Frame, ShardMesh, shuffle, shuffle_hierarchical
from ..relational.table import date_to_days
from .mesh import data_axes, make_sql_mesh

SF = 100
BASE_ROWS = {"lineitem": 6_001_215, "orders": 1_500_000, "customer": 150_000}
SHAPES = ("q1", "q3", "q3pt", "q3c", "q3ptc")

Q3_CUTOFF = date_to_days("1995-03-15")
Q3_SEGMENT = 1          # BUILDING's dictionary code
Q3_SLACK = 2.0
Q3_PT_SEL = 0.15
Q3_BLOOM_BITS = 1 << 22
TOPK = 10
Q1_CUTOFF = date_to_days("1998-09-02")
Q1_GROUPS = 9


def rows(sf: float = SF) -> Dict[str, int]:
    return {t: int(r * sf) for t, r in BASE_ROWS.items()}


ROWS = rows(SF)


def _round_up(x: int, m: int = 128) -> int:
    return ((x + m - 1) // m) * m


def _caps(n_shards: int, sf: float = SF) -> Dict[str, int]:
    return {t: _round_up(-(-r // n_shards)) for t, r in rows(sf).items()}


@dataclasses.dataclass(frozen=True)
class Spec:
    """An input's shape and dtype (the reference's ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _mesh(multi_pod: bool, mesh: Optional[ShardMesh]) -> ShardMesh:
    return make_sql_mesh(multi_pod=multi_pod) if mesh is None else mesh


def q3_inputs(n_shards: int, compress: bool = False, sf: float = SF):
    """compress=True: planner-narrowed physical types (the paper's future
    work, lightweight compression): SF100 order keys fit int32, the
    discount is a dictionary of 11 hundredths → uint8 codes, the ship date
    stays int32, money float32.  It halves the widths that dominate the
    shuffles and the sort."""
    c = _caps(n_shards, sf)
    key_t = torch.int32 if compress else torch.int64
    disc_t = torch.uint8 if compress else torch.float32
    code_t = torch.int8 if compress else torch.int32

    def spec(table, dtype):
        return Spec((n_shards, c[table]), dtype)

    li = {"l_orderkey": spec("lineitem", key_t),
          "l_extendedprice": spec("lineitem", torch.float32),
          "l_discount": spec("lineitem", disc_t),
          "l_shipdate": spec("lineitem", torch.int32)}
    oo = {"o_orderkey": spec("orders", key_t),
          "o_custkey": spec("orders", key_t),
          "o_orderdate": spec("orders", torch.int32),
          "o_shippriority": spec("orders", code_t)}
    cu = {"c_custkey": spec("customer", key_t),
          "c_mktsegment": spec("customer", code_t)}
    valid = {t: spec(t, torch.bool) for t in ("lineitem", "orders", "customer")}
    return li, oo, cu, valid, c


def build_q3_fragment(multi_pod: bool, predicate_transfer: bool = False,
                      compress: bool = False, *, sf: float = SF,
                      mesh: Optional[ShardMesh] = None):
    """→ (fragment, input specs, extra).  ``fragment(mesh, lcols, lvalid,
    ocols, ovalid, ccols, cvalid)`` returns each shard's top-10 orders by
    revenue (key, revenue, o_orderdate, o_shippriority, valid:
    ``(n_shards, 10)``) and the shuffles' overflow count (0-d, the whole
    mesh's).  ``extra`` holds the reference's ``n_shards``, ``caps`` and
    ``shuffle_out_caps``, and on two pods the pod stage's buckets
    (``pod_caps``).

    predicate_transfer=True inserts the Bloom pre-filter: lineitem rows
    that cannot join any filtered order are dropped before the all_to_all,
    and the planner sizes the lineitem buckets for 15% of the rows.
    """
    mesh = _mesh(multi_pod, mesh)
    n_data = mesh.axis_size("data")
    n_shards = mesh.size
    li, oo, cu, valid, caps = q3_inputs(n_shards, compress, sf)
    # predicate transfer tightens the planner's estimate of the lineitem
    # shuffle: only ~9% of lineitem joins a BUILDING, date-filtered order
    # (catalog estimate plus the Bloom filter's false positives)
    pt_sel = Q3_PT_SEL if predicate_transfer else 1.0
    o_out = _round_up(int(caps["orders"] * Q3_SLACK / n_data) + 8, 8)
    l_out = _round_up(int(caps["lineitem"] * Q3_SLACK * pt_sel / n_data) + 8, 8)
    o_pod = _round_up(int(caps["orders"] * Q3_SLACK / 2) + 8, 8)
    l_pod = _round_up(int(caps["lineitem"] * Q3_SLACK * pt_sel / 2) + 8, 8)

    def fragment(mesh, lcols, lvalid, ocols, ovalid, ccols, cvalid):
        # customer filter + co-located semi join
        cmask = cvalid & (ccols["c_mktsegment"] == Q3_SEGMENT)
        ofr = Frame({k: ocols[k] for k in ("o_orderkey", "o_orderdate",
                                           "o_shippriority")},
                    ovalid & (ocols["o_orderdate"] < Q3_CUTOFF))
        ofr = static_semi_join(ofr, ocols["o_custkey"], ccols["c_custkey"],
                               cmask)
        # exchange: orders shuffled to their order key's shard
        if multi_pod:
            ofr, ov1 = shuffle_hierarchical(ofr, "o_orderkey", mesh, "pod",
                                            "data", o_pod, o_out)
        else:
            ofr, ov1 = shuffle(ofr, ofr.columns["o_orderkey"], mesh, o_out)
        # lineitem filter (+ the Bloom predicate transfer) + shuffle
        lmask = lvalid & (lcols["l_shipdate"] > Q3_CUTOFF)
        if predicate_transfer:
            bits = bloom_or_across(
                bloom_build(ofr.columns["o_orderkey"], ofr.valid,
                            Q3_BLOOM_BITS), mesh, data_axes(mesh))
            lmask = lmask & bloom_maybe_contains(bits, lcols["l_orderkey"])
        lfr = Frame({k: lcols[k] for k in ("l_orderkey", "l_extendedprice",
                                           "l_discount")}, lmask)
        if multi_pod:
            lfr, ov2 = shuffle_hierarchical(lfr, "l_orderkey", mesh, "pod",
                                            "data", l_pod, l_out)
        else:
            lfr, ov2 = shuffle(lfr, lfr.columns["l_orderkey"], mesh, l_out)
        # co-located PK-FK join + grouped aggregate + local top-k
        j = static_inner_join(lfr, lfr.columns["l_orderkey"], ofr,
                              ofr.columns["o_orderkey"])
        disc = j.columns["l_discount"]
        if compress:   # dequantize the dictionary code at use
            disc = disc.to(torch.float32) * 0.01
        rev = j.columns["l_extendedprice"] * (1.0 - disc)
        agg, _ = local_sort_agg(
            j, j.columns["l_orderkey"], sums={"revenue": rev},
            firsts={"o_orderdate": j.columns["o_orderdate"],
                    "o_shippriority": j.columns["o_shippriority"]})
        top = static_topk(agg, agg.columns["revenue"], TOPK)
        return (top.columns["key"], top.columns["revenue"],
                top.columns["o_orderdate"], top.columns["o_shippriority"],
                top.valid, (ov1 + ov2)[0])

    inputs = (li, valid["lineitem"], oo, valid["orders"], cu,
              valid["customer"])
    extra = {"n_shards": n_shards, "caps": caps,
             "shuffle_out_caps": {"orders": o_out, "lineitem": l_out}}
    if multi_pod:
        extra["pod_caps"] = {"orders": o_pod, "lineitem": l_pod}
    return fragment, inputs, extra


def build_q1_fragment(multi_pod: bool, *, sf: float = SF,
                      mesh: Optional[ShardMesh] = None):
    """Q1: scan → filter → 9-group aggregate → psum (the compute-bound
    contrast).  ``fragment(mesh, cols, valid)`` → the ``(9, 6)`` float32
    sums every shard holds after the psum: per group (return flag x 3 +
    line status) sum of quantity, price, discounted price, charge,
    discount, and the row count."""
    mesh = _mesh(multi_pod, mesh)
    n_shards = mesh.size
    c = _caps(n_shards, sf)["lineitem"]

    def spec(dtype):
        return Spec((n_shards, c), dtype)

    cols = {"l_shipdate": spec(torch.int32),
            "l_returnflag": spec(torch.int32),
            "l_linestatus": spec(torch.int32),
            "l_quantity": spec(torch.float32),
            "l_extendedprice": spec(torch.float32),
            "l_discount": spec(torch.float32),
            "l_tax": spec(torch.float32)}

    def fragment(mesh, cc, valid):
        mask = valid & (cc["l_shipdate"] <= Q1_CUTOFF)
        gid = cc["l_returnflag"] * 3 + cc["l_linestatus"]
        gid = torch.where(mask, gid, Q1_GROUPS)
        ext, disc = cc["l_extendedprice"], cc["l_discount"]
        disc_price = ext * (1.0 - disc)
        vals = torch.stack([cc["l_quantity"], ext, disc_price,
                            disc_price * (1.0 + cc["l_tax"]), disc,
                            torch.ones_like(ext)], dim=-1)
        vals = torch.where(mask.unsqueeze(-1), vals, 0.0)
        partial = shard_segment_sum(vals, gid, Q1_GROUPS + 1)[:, :Q1_GROUPS]
        for ax in data_axes(mesh):
            partial = mesh.psum(partial, ax)
        return partial[0]

    return fragment, (cols, spec(torch.bool)), {"n_shards": n_shards, "cap": c}


def lower_sql_fragment(shape_name: str, multi_pod: bool, *, sf: float = SF,
                       mesh: Optional[ShardMesh] = None):
    """The fragment of a dry-run shape (``q1``, ``q3``, ``q3pt``, ``q3c``,
    ``q3ptc``, with or without an ``_sf100`` suffix) → (fragment, input
    specs, extra with the reference's ``kind`` and ``sf``).  Nothing is
    lowered: the port runs the fragment eagerly."""
    variant = shape_name.split("_")[0]
    if variant not in SHAPES:
        raise ValueError(f"unknown sql dry-run shape {shape_name}")
    if variant.startswith("q3"):
        fn, args, extra = build_q3_fragment(
            multi_pod, predicate_transfer="pt" in variant,
            compress="c" in variant, sf=sf, mesh=mesh)
    else:
        fn, args, extra = build_q1_fragment(multi_pod, sf=sf, mesh=mesh)
    return fn, args, {"kind": "sql-fragment", "sf": sf, **extra}
