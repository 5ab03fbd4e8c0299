"""Production meshes — counterpart of ``repro/launch/mesh.py``.

A mesh here is a ``ShardMesh`` of logical shards: named axes and their
sizes over one device, a collective a tensor operation over the shard axis
(``exchange/service.py``).  ``device=None`` means the card; the CPU is used
only when a caller asks for it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..exchange.service import ShardMesh


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device] = None) -> ShardMesh:
    """16 x 16 = 256 shards a pod; 2 pods = 512 for the multi-pod pass (the
    model half of the dry run, ROADMAP queue 1)."""
    axes = (("data", 16), ("model", 16))
    if multi_pod:
        axes = (("pod", 2),) + axes
    return ShardMesh(axes, _device(device))


def make_sql_mesh(*, multi_pod: bool = False,
                  device: Optional[torch.device] = None) -> ShardMesh:
    """SQL-engine mesh: fragments shard over a flat ``data`` axis (one shard
    a chip); the ``pod`` axis nests for the hierarchical shuffle."""
    axes = (("pod", 2), ("data", 256)) if multi_pod else (("data", 256),)
    return ShardMesh(axes, _device(device))


def data_axes(mesh: ShardMesh) -> tuple:
    """The batch-parallel axes of a mesh (pod folds into data parallelism)."""
    names = [name for name, _ in mesh.axes]
    return tuple(n for n in ("pod", "data") if n in names)
