"""Predicate transfer via Bloom filters — counterpart of
``repro/exchange/bloom.py``, with the same bits.

Before shuffling the probe side of a distributed join, each shard builds a
Bloom filter over its (already filtered) build-side keys; the filters are
OR-combined across shards with one small collective (pmax on bit bytes),
and probe rows that cannot match are dropped *before* the all_to_all.

False positives only cost wasted shuffle bytes (the join rejects them);
false negatives cannot occur.  Double hashing (h1 + i·h2) gives k probes
from two 64-bit mixes (int64 multiplies that wrap, an arithmetic shift,
Python-style modulo).  Filters work on one shard's keys ``(N,)`` or on
sharded keys ``(n_shards, N)``, the bits along the last axis.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .service import ShardMesh

MIX_A = -7046029254386353131          # golden ratio (build hash family)
MIX_B = -4417276706812531889          # splitmix64 constant


def _h2(keys: torch.Tensor, mix: int) -> torch.Tensor:
    h = keys.to(torch.int64) * mix
    return h ^ (h >> 31)


def bloom_build(keys: torch.Tensor, valid: torch.Tensor, m_bits: int,
                k_hashes: int = 7) -> torch.Tensor:
    """→ uint8[..., m_bits] local Bloom filter (1 byte per bit:
    pmax-combinable).  Every set bit is 1, so the reference's scatter-max
    is a plain scatter of ones; invalid rows write a dump slot past the
    end, dropped (the reference's ``mode="drop"``)."""
    h1 = _h2(keys, MIX_A)
    h2 = _h2(keys, MIX_B) | 1          # odd stride
    bits = torch.zeros(tuple(keys.shape[:-1]) + (m_bits + 1,),
                       dtype=torch.uint8, device=keys.device)
    for i in range(k_hashes):
        idx = torch.remainder(torch.remainder(h1 + i * h2, m_bits) + m_bits,
                              m_bits)
        idx = torch.where(valid, idx, m_bits)
        bits.scatter_(-1, idx, 1)
    return bits[..., :-1]


def bloom_or_across(bits: torch.Tensor, mesh: ShardMesh,
                    axes: Sequence[str]) -> torch.Tensor:
    """OR-combine shard-local filters (pmax over the mesh axes)."""
    for ax in axes:
        bits = mesh.pmax(bits, ax)
    return bits


def bloom_maybe_contains(bits: torch.Tensor, keys: torch.Tensor,
                         k_hashes: int = 7) -> torch.Tensor:
    """Conservative membership: True ⇒ maybe present, False ⇒ surely absent."""
    m_bits = bits.shape[-1]
    h1 = _h2(keys, MIX_A)
    h2 = _h2(keys, MIX_B) | 1
    hit = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for i in range(k_hashes):
        idx = torch.remainder(torch.remainder(h1 + i * h2, m_bits) + m_bits,
                              m_bits)
        hit = hit & (torch.gather(bits, -1, idx) > 0)
    return hit
