r"""String and dictionary subsystem — counterpart of ``repro/relational/strings.py``.

Strings never exist on the device: a string column is an int32 code tensor
plus a *sorted* host-side dictionary (codes are ranks, so integer order on
codes is lexicographic order on strings).  Every string operation is

  1. a **one-time host pass** over the (small) dictionary that produces a
     device artifact — a boolean *code mask*, a contiguous *code range*, or
     a code→code *remap* tensor — and
  2. a gather or compare over the per-row codes on the device.

This module owns step 1 and memoizes it **by dictionary identity**, so the
host pass runs once per (dictionary, operation) and derived dictionaries
come back as the *same object* every time.  Device artifacts are cached per
device.  Cached dictionaries are pinned with strong references; the cache
is unbounded by design (see the reference module) and ``clear_cache()`` is
the explicit reset.

LIKE pattern language: ``%`` any run, ``_`` any char, backslash escapes
(``\%``, ``\_``, ``\\``) match the literal character.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# (id(dictionary), op, params) -> artifact; strong refs in _pins keep the
# dictionary objects alive so an id() can never be recycled onto another
# dictionary while its cache entries exist.
_cache: Dict[Tuple, object] = {}
_pins: Dict[int, np.ndarray] = {}

stats = {"host_passes": 0, "cache_hits": 0}


def _cached(dictionary, op: str, params: Tuple, compute):
    """Memoize ``compute()`` by dictionary identity.

    ``dictionary`` is one np.ndarray or a tuple of them (two-dictionary
    operations: merge, recode); every participating dictionary is pinned."""
    dicts = dictionary if isinstance(dictionary, tuple) else (dictionary,)
    key = (tuple(id(d) for d in dicts), op, params)
    hit = _cache.get(key)
    if hit is not None:
        stats["cache_hits"] += 1
        return hit
    stats["host_passes"] += 1
    for d in dicts:
        _pins[id(d)] = d
    out = _cache[key] = compute()
    return out


def _on_device(dictionary, op: str, params: Tuple, host_fn, device) -> torch.Tensor:
    """Device copy of a cached host artifact, itself cached per device."""
    device = torch.device(device)
    return _cached(dictionary, op + "@dev", params + (str(device),),
                   lambda: torch.from_numpy(np.asarray(host_fn())).to(device))


def clear_cache() -> None:
    """Drop all memoized artifacts (tests / memory pressure)."""
    _cache.clear()
    _pins.clear()


# ---------------------------------------------------------------------------
# LIKE pattern analysis
# ---------------------------------------------------------------------------


def like_to_regex(pattern: str) -> re.Pattern:
    """SQL LIKE pattern → anchored regex.  Backslash escapes the next char."""
    out = []
    i, n = 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def analyze_like(pattern: str) -> Tuple[str, str]:
    """Classify a LIKE pattern → ("exact"|"prefix"|"general", literal)."""
    lit: List[str] = []
    i, n = 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            lit.append(pattern[i + 1])
            i += 2
            continue
        if ch == "%":
            if i == n - 1:
                return "prefix", "".join(lit)
            return "general", ""
        if ch == "_":
            return "general", ""
        lit.append(ch)
        i += 1
    return "exact", "".join(lit)


# ---------------------------------------------------------------------------
# code masks / ranges (predicate artifacts)
# ---------------------------------------------------------------------------


def like_host_mask(dictionary: np.ndarray, pattern: str) -> np.ndarray:
    """Host bool mask over the dictionary: entry matches the LIKE pattern."""
    def compute():
        rx = like_to_regex(pattern)
        return np.fromiter((rx.match(s) is not None for s in dictionary),
                           bool, len(dictionary))
    return _cached(dictionary, "like_host", (pattern,), compute)


def like_mask(dictionary: np.ndarray, pattern: str, device) -> torch.Tensor:
    """Device bool mask over dictionary codes for a LIKE pattern."""
    return _on_device(dictionary, "like", (pattern,),
                      lambda: like_host_mask(dictionary, pattern), device)


def in_list_mask(dictionary: np.ndarray, values: Sequence[str],
                 device) -> torch.Tensor:
    """Device bool mask over dictionary codes for an IN list."""
    vals = tuple(values)
    # no dtype cast: forcing the dictionary's fixed U-width would truncate
    # longer IN values into false-positive matches
    return _on_device(dictionary, "in_list", (vals,),
                      lambda: np.isin(dictionary, np.asarray(list(vals))),
                      device)


def prefix_range(dictionary: np.ndarray, prefix: str) -> Tuple[int, int]:
    """Code range [lo, hi) whose dictionary entries start with ``prefix``."""
    def compute():
        lo = int(np.searchsorted(dictionary, prefix, side="left"))
        tail = dictionary[lo:]
        if len(tail) == 0 or prefix == "":
            return (lo, len(dictionary))
        hi = lo + int(np.char.startswith(tail, prefix).sum())
        return (lo, hi)
    return _cached(dictionary, "prefix", (prefix,), compute)


def exact_code(dictionary: np.ndarray, literal: str) -> Optional[int]:
    """Code of ``literal`` in the dictionary, or None when absent."""
    def compute():
        pos = int(np.searchsorted(dictionary, literal, side="left"))
        ok = pos < len(dictionary) and dictionary[pos] == literal
        return (pos if ok else None,)
    return _cached(dictionary, "exact", (literal,), compute)[0]


# ---------------------------------------------------------------------------
# dictionary transforms (code → code)
# ---------------------------------------------------------------------------


def _substr_host(dictionary: np.ndarray, start: int, length: int):
    def compute():
        subs = np.asarray(
            [s[start - 1: start - 1 + length] for s in dictionary])
        derived, remap = np.unique(subs, return_inverse=True)
        return derived, remap.astype(np.int32)
    return _cached(dictionary, "substr", (start, length), compute)


def substr_transform(dictionary: np.ndarray, start: int, length: int,
                     device) -> Tuple[np.ndarray, torch.Tensor]:
    """SQL substring as a dictionary transform → (derived dict, device remap).

    Identity-stable: the same input dictionary always yields the *same*
    derived dictionary object."""
    derived, _ = _substr_host(dictionary, start, length)
    remap = _on_device(dictionary, "substr", (start, length),
                       lambda: _substr_host(dictionary, start, length)[1],
                       device)
    return derived, remap


def merged_dictionary(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Sorted union of two dictionaries (identity-stable per input pair)."""
    if left is right:
        return left
    return _cached((left, right), "merge", (),
                   lambda: np.unique(np.concatenate([left, right])))


def _recode_host(src: np.ndarray, target: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(target, src)
    pos = np.clip(pos, 0, max(len(target) - 1, 0))
    ok = (target[pos] == src) if len(target) else np.zeros(len(src), bool)
    return np.where(ok, pos, -1).astype(np.int32)


def recode_map(src: np.ndarray, target: np.ndarray, device) -> torch.Tensor:
    """Device int32 map from ``src`` codes to ``target`` codes (-1 = absent)."""
    return _on_device((src, target), "recode", (),
                      lambda: _recode_host(src, target), device)


# ---------------------------------------------------------------------------
# dictionary-informed selectivity (optimizer stats hooks)
# ---------------------------------------------------------------------------


def like_selectivity(dictionary: np.ndarray, pattern: str) -> float:
    """Fraction of dictionary entries matching the pattern (hit rate).

    Codes are treated as uniform (no per-code frequencies)."""
    n = len(dictionary)
    if n == 0:
        return 0.0
    return float(like_host_mask(dictionary, pattern).sum()) / n


def in_selectivity(dictionary: np.ndarray, values: Sequence[str]) -> float:
    n = len(dictionary)
    if n == 0:
        return 0.0
    hits = sum(1 for v in values if exact_code(dictionary, str(v)) is not None)
    return hits / n


def prefix_selectivity(dictionary: np.ndarray, prefix: str) -> float:
    n = len(dictionary)
    if n == 0:
        return 0.0
    lo, hi = prefix_range(dictionary, prefix)
    return (hi - lo) / n


def eq_selectivity(dictionary: np.ndarray, literal: str) -> float:
    n = len(dictionary)
    if n == 0:
        return 0.0
    return (1.0 if exact_code(dictionary, literal) is not None else 0.0) / n
