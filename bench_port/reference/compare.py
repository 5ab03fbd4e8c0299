"""The comparison that decides ``correct``: one query's host result
against the reference's.

Two numbers come out of it.  ``mismatched`` counts what must be exact: a
column missing or extra, a row count, an integer, date or string cell
that differs, and a pair of neighbouring rows out of the ORDER BY's
order.  ``float_err`` is the widest gap of a float cell,
``|got - want| / max(|want|, 1)``: relative for money and counts above 1,
absolute below (shares, averages of discounts).  NaN matches NaN.

Rows are matched as sets (both sides sorted by every column, the exact
ones first), and the order is checked on the engine's rows by the
reference's ORDER BY keys: two rows whose float key lies within ``tie``
of each other tie but for rounding, and may come in either order.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _is_float(a: np.ndarray) -> bool:
    return a.dtype.kind == "f"


def _gap(g: np.ndarray, w: np.ndarray) -> np.ndarray:
    gf, wf = g.astype(np.float64), w.astype(np.float64)
    both_nan = np.isnan(gf) & np.isnan(wf)
    gap = np.where(both_nan, 0.0, np.abs(gf - wf) / np.maximum(np.abs(wf), 1.0))
    return np.where(np.isnan(gap), np.inf, gap)


def _exact(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "M":
        return a.astype("datetime64[D]").astype(np.int64)
    if a.dtype.kind in "iub":
        return a.astype(np.int64)
    return a.astype(str)


def _row_order(cols: Dict[str, np.ndarray], names) -> np.ndarray:
    exact = [n for n in names if not _is_float(cols[n])]
    floats = [n for n in names if _is_float(cols[n])]
    keys = [_exact(cols[n]) for n in exact] + [cols[n].astype(np.float64) for n in floats]
    return np.lexsort(keys[::-1]) if keys else np.arange(0)


def _out_of_order(got: Dict[str, np.ndarray], order: Sequence[Tuple[str, bool]],
                  tie: float) -> int:
    n = len(next(iter(got.values()))) if got else 0
    if n < 2 or not order:
        return 0
    undecided = np.ones(n - 1, dtype=bool)    # pairs equal on the keys so far
    bad = np.zeros(n - 1, dtype=bool)
    for name, desc in order:
        a = got[name]
        if _is_float(a):
            x, y = a[:-1].astype(np.float64), a[1:].astype(np.float64)
            tied = _gap(x, y) <= tie
            bad |= undecided & ~tied & ((x < y) if desc else (x > y))
            break               # decided here, or free when tied
        x, y = _exact(a[:-1]), _exact(a[1:])
        bad |= undecided & ((x < y) if desc else (x > y))
        undecided &= x == y
    return int(bad.sum())


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
            tie: float = 0.0) -> Tuple[int, float, str]:
    """→ (mismatched cells and pairs, widest float gap, a note on the
    first fault)."""
    if set(got) != set(want):
        return 1, 0.0, f"columns {sorted(got)} vs {sorted(want)}"
    got = {k: np.asarray(v) for k, v in got.items()}
    names = list(want)
    n_got = len(got[names[0]]) if names else 0
    n_want = len(np.asarray(want[names[0]])) if names else 0
    if n_got != n_want:
        return 1, 0.0, f"{n_got} rows vs {n_want}"
    gi, wi = _row_order(got, names), _row_order({k: np.asarray(v) for k, v in want.items()}, names)
    mismatched, worst, note = 0, 0.0, ""
    for name in names:
        g, w = got[name][gi], np.asarray(want[name])[wi]
        if _is_float(g) or _is_float(w):
            gap = _gap(g, w)
            if gap.size:
                worst = max(worst, float(gap.max()))
            continue
        bad = _exact(g) != _exact(w)
        n_bad = int(np.count_nonzero(bad))
        if n_bad and not note:
            i = int(np.flatnonzero(bad)[0])
            note = f"{name}: {g[i]!r} vs {w[i]!r}"
        mismatched += n_bad
    wrong_order = _out_of_order(got, getattr(want, "order", []), tie)
    if wrong_order and not note:
        note = f"{wrong_order} neighbouring rows out of order"
    return mismatched + wrong_order, worst, note
