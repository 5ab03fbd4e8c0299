"""Static-shape relational operators for fixed-shape fragments —
counterpart of ``repro/core/static_ops.py``.

Every shape is fixed: row counts are carried by validity masks, joins
probe fixed-capacity hash tables, and aggregation is sort-based within the
shard (argsort + segment boundaries + segment sums, all dense tensor ops;
nothing waits for the device).

A frame is one shard's (``valid`` of shape ``(cap,)``, as in the
reference's ``shard_map`` body) or a sharded one (``(n_shards, cap)``, as
on a ``ShardMesh``): each operator then works on every shard side by side,
shard ``s`` getting what the one-shard call on its rows gives.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from ..exchange.service import Frame, take_rows
from ..relational.aggregate import segment_sum
from ..relational.join import StaticHashTable

I64_MAX = torch.iinfo(torch.int64).max


def pack_keys(cols: Sequence[torch.Tensor], cards: Sequence[int]) -> torch.Tensor:
    """Pack dense non-negative int key columns into one int64 (static cards)."""
    out = cols[0].to(torch.int64)
    for c, card in zip(cols[1:], cards[1:]):
        out = out * card + c.to(torch.int64)
    return out


def shard_segment_sum(data: torch.Tensor, gid: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Per-shard segment sums: ``gid`` is ``(..., rows)`` in ``[0, n)``,
    ``data`` ``(..., rows)`` or ``(..., rows, cols)`` → ``(..., n)`` or
    ``(..., n, cols)``, each shard's own segments (one ``segment_sum`` over
    every shard's rows, ``n`` ids a shard)."""
    lead = tuple(gid.shape[:-1])
    shards = math.prod(lead)
    base = torch.arange(shards, device=gid.device).reshape(lead + (1,))
    flat = (gid + base * n).reshape(-1)
    rest = tuple(data.shape[gid.dim():])
    out = segment_sum(data.reshape((-1,) + rest), flat, shards * n)
    return out.reshape(lead + (n,) + rest)


def local_sort_agg(frame: Frame, key: torch.Tensor,
                   sums: Dict[str, torch.Tensor],
                   firsts: Dict[str, torch.Tensor] | None = None
                   ) -> Tuple[Frame, torch.Tensor]:
    """Shard-local group-by: sort rows by key, segment-reduce runs.

    ``sums``   name -> per-row value to sum within each key group (float64)
    ``firsts`` name -> per-row value carried through (same for all rows of a
               key, e.g. o_orderdate for key o_orderkey)
    Returns (Frame with 'key', sums, firsts, and '__count'; valid marks the
    unique keys), plus the sorted key array (for debugging).
    """
    cap = frame.capacity
    lead = tuple(frame.valid.shape[:-1])
    dev = frame.valid.device
    skey = torch.where(frame.valid, key.to(torch.int64), I64_MAX)
    order = torch.sort(skey, dim=-1, stable=True).indices
    k_sorted = torch.gather(skey, -1, order)
    v_sorted = torch.gather(frame.valid, -1, order)

    is_start = torch.cat([torch.ones(lead + (1,), dtype=torch.bool, device=dev),
                          k_sorted[..., 1:] != k_sorted[..., :-1]], -1) & v_sorted
    gid = torch.cumsum(is_start, -1) - 1               # segment id per row
    gid = torch.where(v_sorted, gid, cap)              # invalid rows dumped
    base = torch.arange(math.prod(lead), device=dev).reshape(lead + (1,))
    flat = (gid + base * (cap + 1)).reshape(-1)        # each shard's slots

    out_cols: Dict[str, torch.Tensor] = {}
    out_cols["__count"] = shard_segment_sum(
        v_sorted.to(torch.float64), gid, cap + 1)[..., :-1]
    for name, vals in sums.items():
        vs = torch.where(v_sorted, torch.gather(vals, -1, order)
                         .to(torch.float64), 0.0)
        out_cols[name] = shard_segment_sum(vs, gid, cap + 1)[..., :-1]
    out_key = torch.full(lead + (cap + 1,), I64_MAX, dtype=torch.int64,
                         device=dev)
    out_key.view(-1)[flat] = k_sorted.reshape(-1)
    out_cols["key"] = out_key[..., :-1]
    if firsts:
        for name, vals in firsts.items():
            vs = torch.gather(vals, -1, order)
            buf = torch.zeros(lead + (cap + 1,), dtype=vs.dtype, device=dev)
            buf.view(-1)[flat] = vs.reshape(-1)
            out_cols[name] = buf[..., :-1]
    out_valid = out_cols["key"] != I64_MAX
    return Frame(out_cols, out_valid), k_sorted


def static_semi_join(frame: Frame, key: torch.Tensor, build_keys: torch.Tensor,
                     build_valid: torch.Tensor, anti: bool = False) -> Frame:
    """Filter frame rows by membership of ``key`` in the build key set."""
    safe = torch.where(build_valid, build_keys.to(torch.int64), -1)
    ht = StaticHashTable.build(safe, valid=build_valid)
    _, found = ht.lookup(key.to(torch.int64))
    keep = ~found if anti else found
    return frame.with_mask(keep)


def static_inner_join(probe: Frame, probe_key: torch.Tensor, build: Frame,
                      build_key: torch.Tensor) -> Frame:
    """PK-FK inner join: build side unique keys; output rows = probe rows."""
    safe = torch.where(build.valid, build_key.to(torch.int64), -1)
    ht = StaticHashTable.build(safe, valid=build.valid)
    row, found = ht.lookup(probe_key.to(torch.int64))
    safe_row = torch.clamp(row, min=0).long()
    cols = dict(probe.columns)
    for name, col in build.columns.items():
        if name not in cols:
            cols[name] = take_rows(col, safe_row)
    return Frame(cols, probe.valid & found)


def static_topk(frame: Frame, score: torch.Tensor, k: int,
                descending: bool = True) -> Frame:
    """Keep the k best rows by score (masked).  Ties keep the lower row
    first, as ``jax.lax.top_k`` does (a stable sort; ``torch.topk`` makes
    no such promise)."""
    s = score.to(torch.float64)
    neg_inf = torch.finfo(torch.float64).min
    masked = torch.where(frame.valid, s if descending else -s, neg_inf)
    idx = torch.sort(masked, dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return frame.take(idx, torch.gather(frame.valid, -1, idx))
