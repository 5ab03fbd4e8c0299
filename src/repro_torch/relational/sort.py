"""Order-by — counterpart of ``repro/relational/sort.py``.

A device lexsort on the encoded sort keys (order-preserving dictionary
codes make string sorts integer sorts).  torch has no ``lexsort``, so it is
built from successive stable sorts, least significant key first.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from .table import Table


@dataclasses.dataclass
class SortKey:
    name: str
    ascending: bool = True


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row order sorting by ``keys[0]``, ties by ``keys[1]``, and so on.

    The order is stable, as ``jnp.lexsort`` (whose *last* key is the
    primary one) is: equal rows keep their input order."""
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for k in reversed(list(keys)):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def sort_table(table: Table, keys: Sequence[SortKey], limit: int | None = None) -> Table:
    if table.num_rows == 0:
        return table
    arrays: List[torch.Tensor] = []
    for k in keys:
        a = table[k.name].data
        if a.dtype == torch.bool:
            a = a.to(torch.int8)
        if not k.ascending:
            if a.dtype.is_floating_point:
                a = -a
            else:
                a = -(a.to(torch.int64))
        arrays.append(a)
    order = lexsort(arrays)
    if limit is not None:
        order = order[:limit]
    return table.take(order)
