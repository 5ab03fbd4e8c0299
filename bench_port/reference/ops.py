"""Plain PyTorch building blocks of the reference queries.

The reference reads the generated columns (``datagen``'s ``Dataset``) and
nothing the engine made: joins are key lookups by sort and search, groups
are dense ranks of their keys, strings are matched on the sorted
dictionaries and mapped to rows through a table of codes.  ``float_dtype``
is the precision money is computed in: float64, as the configurations
state, or float32 for the control that has to fail.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

EPOCH = np.datetime64("1970-01-01", "D")


def like_regex(pattern: str) -> "re.Pattern":
    parts = []
    for ch in pattern:
        parts.append(".*" if ch == "%" else "." if ch == "_" else re.escape(ch))
    return re.compile("".join(parts), re.DOTALL)


class Ref:
    """One dataset seen by the reference, with money in ``float_dtype``."""

    def __init__(self, ds, float_dtype=torch.float64):
        self.ds = ds
        self.f = float_dtype
        first = next(iter(next(iter(ds.tables.values())).values()))
        self.device = first.device

    # -- columns -----------------------------------------------------------
    def col(self, table: str, name: str) -> torch.Tensor:
        x = self.ds.tables[table][name]
        if x.is_floating_point() and x.dtype != self.f:
            return x.to(self.f)
        return x

    def dictionary(self, table: str, name: str) -> np.ndarray:
        return self.ds.dictionaries[table][name]

    def lit(self, v) -> torch.Tensor:
        return torch.tensor(float(v), dtype=self.f, device=self.device)

    def code(self, table: str, name: str, value: str) -> int:
        d = self.dictionary(table, name)
        i = int(np.searchsorted(d, value))
        return i if i < len(d) and d[i] == value else -1

    def eq(self, table: str, name: str, value: str) -> torch.Tensor:
        return self.col(table, name) == self.code(table, name, value)

    def isin(self, table: str, name: str, values: Sequence[str]) -> torch.Tensor:
        d = self.dictionary(table, name)
        lut = np.isin(d, np.asarray(list(values)))
        return self._lut(lut, self.col(table, name))

    def like(self, table: str, name: str, pattern: str) -> torch.Tensor:
        rx = like_regex(pattern)
        d = self.dictionary(table, name)
        lut = np.fromiter((rx.fullmatch(s) is not None for s in d), bool,
                          len(d))
        return self._lut(lut, self.col(table, name))

    def _lut(self, lut: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
        t = torch.from_numpy(lut).to(self.device)
        return t[codes.long()]

    def derived_strings(self, table: str, name: str, fn) -> Tuple[torch.Tensor, np.ndarray]:
        """Apply ``fn`` to each dictionary value → (codes into the sorted
        dictionary of results, that dictionary)."""
        d = self.dictionary(table, name)
        mapped = np.asarray([fn(s) for s in d])
        out_dict, remap = np.unique(mapped, return_inverse=True)
        lut = torch.from_numpy(remap.astype(np.int64)).to(self.device)
        return lut[self.col(table, name).long()], out_dict

    def year(self, days: torch.Tensor) -> torch.Tensor:
        if days.numel() == 0:
            return days.long()
        lo, hi = int(days.min()), int(days.max())
        span = EPOCH + np.arange(lo, hi + 1).astype("timedelta64[D]")
        years = span.astype("datetime64[Y]").astype(np.int64) + 1970
        lut = torch.from_numpy(years).to(self.device)
        return lut[(days.long() - lo)]


def lookup(build_keys: torch.Tensor, probe_keys: torch.Tensor) -> torch.Tensor:
    """Row of each probe key among unique ``build_keys``, or -1."""
    srt, perm = torch.sort(build_keys)
    pos = torch.searchsorted(srt, probe_keys)
    pos_c = pos.clamp(max=max(srt.numel() - 1, 0))
    found = (pos < srt.numel()) & (srt[pos_c] == probe_keys)
    return torch.where(found, perm[pos_c], torch.full_like(pos, -1))


def pair_key(a: torch.Tensor, b: torch.Tensor, b_max: int) -> torch.Tensor:
    return a.long() * (int(b_max) + 1) + b.long()


def group(keys: List[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """Dense group ids of the rows' key tuples, numbered in the keys'
    lexicographic order → (gid, number of groups)."""
    gid = None
    for k in keys:
        rank = torch.unique(k, sorted=True, return_inverse=True)[1]
        if gid is None:
            gid = rank
        else:
            n = int(rank.max()) + 1 if rank.numel() else 1
            gid = torch.unique(gid * n + rank, sorted=True,
                               return_inverse=True)[1]
    if gid is None or gid.numel() == 0:
        return gid, 0
    return gid, int(gid.max()) + 1


def seg_sum(values: torch.Tensor, gid: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, gid, values)


def seg_count(gid: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(gid, minlength=n).long()


def first(values: torch.Tensor, gid: torch.Tensor, n: int) -> torch.Tensor:
    """A value of each group: for columns the group determines."""
    out = torch.empty(n, dtype=values.dtype, device=values.device)
    out[gid] = values
    return out


def count_distinct(gid: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """Distinct ``values`` in each group."""
    if values.numel() == 0:
        return torch.zeros(n, dtype=torch.int64, device=values.device)
    v = torch.unique(values, return_inverse=True)[1]
    m = int(v.max()) + 1
    pairs = torch.unique(gid.long() * m + v)
    return seg_count(pairs // m, n)


class Answer(dict):
    """Host columns of a reference answer, with the ORDER BY they follow:
    ``order`` is a list of (column, descending)."""

    order: list = []


class Result:
    """Output columns of one query, sorted and cut on the device, then
    decoded on the host as ``Table.to_host`` would: strings through their
    dictionaries, dates as ``datetime64[D]``."""

    def __init__(self):
        self.cols: Dict[str, tuple] = {}

    def num(self, name: str, t: torch.Tensor) -> "Result":
        self.cols[name] = ("num", t)
        return self

    def string(self, name: str, codes: torch.Tensor, dictionary) -> "Result":
        self.cols[name] = ("str", codes, dictionary)
        return self

    def date(self, name: str, days: torch.Tensor) -> "Result":
        self.cols[name] = ("date", days)
        return self

    def host(self, order: Sequence[Tuple[str, bool]] = (),
             limit: int = None) -> Answer:
        n = next(iter(self.cols.values()))[1].numel()
        dev = next(iter(self.cols.values()))[1].device
        idx = torch.arange(n, device=dev)
        for name, desc in reversed(list(order)):
            key = self.cols[name][1][idx]
            idx = idx[torch.sort(key, stable=True, descending=desc).indices]
        if limit is not None:
            idx = idx[:limit]
        out = Answer()
        out.order = list(order)
        for name, spec in self.cols.items():
            data = spec[1][idx].cpu().numpy()
            if spec[0] == "str":
                out[name] = np.asarray(spec[2])[data]
            elif spec[0] == "date":
                out[name] = EPOCH + data.astype("timedelta64[D]")
            else:
                out[name] = data
        return out
