"""Columnar Table on torch tensors — counterpart of ``repro/relational/table.py``.

The dtypes are the reference's contract (it runs JAX with x64 on):
  * keys and other integers are int64;
  * money and other decimals are float64;
  * dates are int32 days since 1970-01-01;
  * strings are int32 codes into a sorted host dictionary, so integer order
    on codes is lexicographic order on strings.

A Table's tensors all live on one device.  ``from_pydict`` builds CPU
tensors (the host format); the buffer manager moves them to the engine's
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

# Logical column kinds.
NUMERIC = "numeric"
STRING = "string"
DATE = "date"
BOOL = "bool"

_EPOCH = np.datetime64("1970-01-01", "D")


def date_to_days(s: str) -> int:
    """'1995-03-15' -> int32 days since epoch."""
    return int((np.datetime64(s, "D") - _EPOCH).astype(np.int64))


def days_to_date(d: int) -> str:
    return str(_EPOCH + np.timedelta64(int(d), "D"))


def dtype_kind(t: torch.Tensor) -> str:
    """numpy-style kind character of a tensor's dtype: b, i, u or f."""
    if t.dtype == torch.bool:
        return "b"
    if t.dtype.is_floating_point:
        return "f"
    if t.dtype == torch.uint8:
        return "u"
    return "i"


@dataclasses.dataclass
class Column:
    """A single column: device tensor + (for strings) a host-side dictionary.

    ``data``       tensor (codes for strings, days for dates)
    ``kind``       NUMERIC | STRING | DATE | BOOL
    ``dictionary`` sorted np.ndarray of python strings (STRING only)
    """

    data: torch.Tensor
    kind: str = NUMERIC
    dictionary: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind == STRING and self.dictionary is None:
            raise ValueError("string column requires a dictionary")

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_strings(values: Sequence[str]) -> "Column":
        arr = np.asarray(values)
        if arr.dtype.kind != "U":
            arr = arr.astype(object).astype(str)
        dictionary, codes = np.unique(arr, return_inverse=True)
        # the reference goes through ``astype(object).astype(str)``, whose
        # width is the longest value's: narrow the dictionary to it, so
        # decoded columns have the reference's dtype (and byte counts)
        width = int(np.char.str_len(dictionary).max()) if len(dictionary) else 0
        dictionary = dictionary.astype(f"<U{max(width, 1)}")
        return Column(torch.from_numpy(codes.astype(np.int32)), STRING,
                      dictionary)

    @staticmethod
    def from_dates(values: Sequence[str]) -> "Column":
        days = (np.asarray(values, dtype="datetime64[D]") - _EPOCH).astype(np.int32)
        return Column(torch.from_numpy(days), DATE)

    @staticmethod
    def from_numpy(arr: np.ndarray) -> "Column":
        if arr.dtype.kind in ("U", "S", "O"):
            return Column.from_strings(arr)
        if arr.dtype.kind == "M":
            days = (arr.astype("datetime64[D]") - _EPOCH).astype(np.int32)
            return Column(torch.from_numpy(days), DATE)
        if arr.dtype == np.bool_:
            return Column(torch.from_numpy(arr.copy()), BOOL)
        return Column(torch.from_numpy(np.ascontiguousarray(arr).copy()),
                      NUMERIC)

    # -- basics ------------------------------------------------------------
    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def take(self, idx: torch.Tensor) -> "Column":
        """Gather rows; every index must be in range (no clamping)."""
        return Column(self.data[idx.long()], self.kind, self.dictionary)

    def to_host(self) -> np.ndarray:
        """Decode to the host-database representation (deep copy)."""
        host = self.data.cpu().numpy()
        if self.kind == STRING:
            return self.dictionary[host]
        if self.kind == DATE:
            return _EPOCH + host.astype("timedelta64[D]")
        return host

    def decode(self) -> np.ndarray:
        return self.to_host()

    # -- dictionary bridging (string join keys across tables) ---------------
    def recode_to(self, target_dictionary: np.ndarray) -> "Column":
        """Map this column's codes into another dictionary's code space.

        Codes not present in the target dictionary map to -1 (never matches).
        """
        if self.kind != STRING:
            raise ValueError("recode_to only applies to string columns")
        from . import strings
        mapping = strings.recode_map(self.dictionary, target_dictionary,
                                     self.data.device)
        return Column(mapping[self.data.long()], STRING, target_dictionary)


class Table:
    """An ordered collection of equal-length Columns."""

    def __init__(self, columns: Dict[str, Column]):
        self.columns: Dict[str, Column] = dict(columns)
        lengths = {len(c) for c in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged table: {lengths}")
        self._num_rows = lengths.pop() if lengths else 0

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_pydict(data: Dict[str, Union[np.ndarray, list]]) -> "Table":
        cols = {}
        for name, values in data.items():
            if isinstance(values, Column):
                cols[name] = values
            else:
                cols[name] = Column.from_numpy(np.asarray(values))
        return Table(cols)

    # -- accessors ----------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())

    @property
    def device(self) -> torch.device:
        """The device of the table's tensors (CPU for a table of no columns)."""
        for c in self.columns.values():
            return c.data.device
        return torch.device("cpu")

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    # -- relational primitives (shared by operators) -------------------------
    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self.columns.items()})

    def with_column(self, name: str, col: Column) -> "Table":
        cols = dict(self.columns)
        cols[name] = col
        return Table(cols)

    def drop(self, names: Sequence[str]) -> "Table":
        return Table({n: c for n, c in self.columns.items() if n not in names})

    def take(self, idx: torch.Tensor) -> "Table":
        return Table({n: c.take(idx) for n, c in self.columns.items()})

    def head(self, n: int) -> "Table":
        return self.take(torch.arange(min(n, self.num_rows),
                                      device=self.device))

    def filter_mask(self, mask: torch.Tensor) -> "Table":
        """Eager compaction (the libcudf apply_boolean_mask analogue).

        ``kernels.ops.compact`` builds the selection with a static size
        (cumsum and scatter); the output size is the one counted scalar
        pull, and the gather stays on the device."""
        from ..core.instrument import pull_scalar
        from ..kernels import ops as kops
        idx, count = kops.compact(mask)
        return self.take(idx[: pull_scalar(count)])

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        tables = list(tables)
        if not tables:
            return Table({})
        names = tables[0].column_names
        out = {}
        for n in names:
            kind = tables[0][n].kind
            if kind == STRING:
                from . import strings
                merged = tables[0][n].dictionary
                for t in tables[1:]:
                    merged = strings.merged_dictionary(merged, t[n].dictionary)
                parts = [t[n].recode_to(merged).data for t in tables]
                out[n] = Column(torch.cat(parts), STRING, merged)
            else:
                out[n] = Column(torch.cat([t[n].data for t in tables]), kind)
        return Table(out)

    # -- host conversion ------------------------------------------------------
    def to_host(self) -> Dict[str, np.ndarray]:
        return {n: c.to_host() for n, c in self.columns.items()}

    def to_pylist(self) -> List[dict]:
        host = self.to_host()
        return [
            {n: host[n][i] for n in self.column_names} for i in range(self.num_rows)
        ]

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}:{c.kind}[{c.data.dtype}]" for n, c in self.columns.items()
        )
        return f"Table({self.num_rows} rows; {cols})"


def unify_string_keys(left: Column, right: Column):
    """Re-encode two string columns into one shared dictionary for joins.

    The merged dictionary and both recode maps come from the
    identity-memoized string subsystem (``relational.strings``)."""
    if left.kind != STRING or right.kind != STRING:
        return left, right
    if left.dictionary is right.dictionary or (
        len(left.dictionary) == len(right.dictionary)
        and np.array_equal(left.dictionary, right.dictionary)
    ):
        return left, right
    from . import strings
    merged = strings.merged_dictionary(left.dictionary, right.dictionary)
    return left.recode_to(merged), right.recode_to(merged)
