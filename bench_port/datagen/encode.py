"""Device-side helpers shared by the generators: seeded random draws and
the encoding of string tokens into sorted dictionaries.

A string column is drawn on the device as int64 *tokens*; ``encode`` turns
them into the engine's form, int32 codes into a sorted host dictionary of
the values present (what ``np.unique`` gives for a host string column).
Only the distinct tokens cross to the host, where ``render`` spells them.
Where token order is string order (``ordered=True``: fixed-width numbers,
or tuples of words from sorted lists joined by a space, which sorts below
every letter) the host sort is skipped.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

EPOCH = np.datetime64("1970-01-01", "D")

SEED_MASK = (1 << 63) - 1


def days(date: str) -> int:
    return int((np.datetime64(date, "D") - EPOCH).astype(np.int64))


class Draw:
    """Seeded draws on one device: thin wrappers over ``torch`` samplers."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(int(seed) & SEED_MASK)

    def integers(self, lo: int, hi: int, n: int) -> torch.Tensor:
        """int64 uniform on [lo, hi)."""
        return torch.randint(lo, hi, (n,), generator=self.g,
                             device=self.device, dtype=torch.int64)

    def random(self, n: int) -> torch.Tensor:
        """float64 uniform on [0, 1)."""
        return torch.rand(n, generator=self.g, device=self.device,
                          dtype=torch.float64)

    def uniform(self, lo: float, hi: float, n: int) -> torch.Tensor:
        return lo + (hi - lo) * self.random(n)

    def sample(self, n_total: int, k: int) -> torch.Tensor:
        """``k`` distinct indices of ``range(n_total)``."""
        return torch.randperm(n_total, generator=self.g,
                              device=self.device)[:k]


def round2(x: torch.Tensor) -> torch.Tensor:
    """``np.round(x, 2)``: half to even on ``x * 100``."""
    return torch.round(x * 100.0) / 100.0


def encode(tokens: torch.Tensor, render: Callable[[np.ndarray], Sequence[str]],
           ordered: bool) -> Tuple[torch.Tensor, np.ndarray]:
    """int64 tokens → (int32 codes on the tokens' device, sorted dictionary
    of the values present)."""
    uniq, inv = torch.unique(tokens, sorted=True, return_inverse=True)
    strs = np.asarray(list(render(uniq.cpu().numpy())))
    if strs.dtype.kind != "U":
        strs = strs.astype(str)
    if ordered:
        return inv.to(torch.int32), strs
    dictionary, remap = np.unique(strs, return_inverse=True)
    remap = torch.from_numpy(remap.astype(np.int32)).to(tokens.device)
    return remap[inv], dictionary


def _word_table(words: Sequence[str], k: int) -> np.ndarray:
    """Every ``k``-word string, the first word most significant."""
    out = list(words)
    for _ in range(k - 1):
        out = [f"{p} {x}" for p in out for x in words]
    return np.asarray(out)


def words_render(words: Sequence[str], k: int):
    """Render base-``len(words)`` tokens as ``k`` space-joined words: a
    table of the leading words' strings joined to one of the trailing
    words' (at most 10^6 entries each)."""
    base = len(words)
    tail = 0
    while tail < k - 1 and base ** (tail + 1) <= 10 ** 6:
        tail += 1
    head_table = _word_table(words, k - tail)
    tail_table = _word_table(words, tail) if tail else None

    def render(tok: np.ndarray):
        t = tok.astype(np.int64)
        if tail_table is None:
            return head_table[t]
        div = base ** tail
        return np.char.add(np.char.add(head_table[t // div], " "),
                           tail_table[t % div])
    return render


def words_tokens(draw: Draw, n: int, n_words: int, k: int) -> torch.Tensor:
    """``k`` word ranks per row as one base-``n_words`` token."""
    tok = torch.zeros(n, dtype=torch.int64, device=draw.device)
    for _ in range(k):
        tok = tok * n_words + draw.integers(0, n_words, n)
    return tok


def digits(v: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII digits of non-negative ``v``, zero-padded."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((v[:, None] // p) % 10 + 48).astype(np.uint8)


def ascii_rows(parts) -> np.ndarray:
    """Join fixed-width parts (byte strings, or (n, w) uint8 matrices)
    row by row into a unicode array."""
    n = next(p.shape[0] for p in parts if isinstance(p, np.ndarray))
    cols = [np.broadcast_to(np.frombuffer(p, np.uint8), (n, len(p)))
            if isinstance(p, bytes) else p for p in parts]
    m = np.ascontiguousarray(np.concatenate(cols, axis=1))
    return m.view(f"S{m.shape[1]}").ravel().astype(f"U{m.shape[1]}")


def padded_render(prefix: str, width: int):
    def render(tok: np.ndarray):
        return ascii_rows([prefix.encode(), digits(tok.astype(np.int64), width)])
    return render


class Dataset:
    """Generated tables in the engine's columnar form, on one device.

    ``tables[t][c]`` is a tensor (int64 keys and integers, float64 money,
    int32 days, int32 string codes), ``kinds[t][c]`` is ``numeric``,
    ``string`` or ``date``, and ``dictionaries[t][c]`` the sorted host
    dictionary of a string column."""

    def __init__(self):
        self.tables = {}
        self.kinds = {}
        self.dictionaries = {}

    def add(self, table: str, column: str, data: torch.Tensor, kind: str,
            dictionary: np.ndarray = None) -> None:
        self.tables.setdefault(table, {})[column] = data.contiguous()
        self.kinds.setdefault(table, {})[column] = kind
        if dictionary is not None:
            self.dictionaries.setdefault(table, {})[column] = dictionary

    def add_strings(self, table: str, column: str, tokens: torch.Tensor,
                    render, ordered: bool) -> None:
        codes, dictionary = encode(tokens, render, ordered)
        self.add(table, column, codes, "string", dictionary)

    def rows(self, table: str) -> int:
        return int(next(iter(self.tables[table].values())).shape[0])

    def column_bytes(self) -> dict:
        """(table, column) → bytes the column holds."""
        return {(t, c): v.numel() * v.element_size()
                for t, cols in self.tables.items() for c, v in cols.items()}

    def nbytes(self) -> int:
        return sum(self.column_bytes().values())
