"""Checkpoint/restore for the exchange registry — counterpart of
``repro/runtime/checkpoint.py``, in the same format, so a snapshot written
by either package loads in the other.

Format: one .npz per snapshot (atomic rename), holding flat arrays plus a
JSON manifest.  Registry snapshots store *compacted valid rows* with their
partition key, so restore can re-shard onto a different mesh size — this is
what makes elastic downsizing after a node failure possible (lineage-consistent
restart from the last completed fragment).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np


def save_npz(path: str, arrays: Dict[str, np.ndarray],
             manifest: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    payload = dict(arrays)
    if manifest is not None:
        payload["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_npz(path: str):
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
        manifest = None
        if "__manifest__" in z.files:
            manifest = json.loads(bytes(z["__manifest__"]).decode())
    return arrays, manifest


class RegistryCheckpointer:
    """Snapshots the exchange temp-table registry after each fragment."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, fragment: str) -> str:
        return os.path.join(self.directory, f"registry_{fragment}.npz")

    def save(self, fragment: str, registry: Dict[str, dict]) -> None:
        arrays = {}
        manifest = {"fragment": fragment, "tables": {}}
        for tname, entry in registry.items():
            manifest["tables"][tname] = {
                "partition_key": entry["partition_key"],
                "columns": list(entry["rows"].keys()),
            }
            for cname, arr in entry["rows"].items():
                key = f"{tname}::{cname}"
                a = np.asarray(arr)
                if a.dtype.kind == "O":
                    a = np.asarray(a, "U")   # npz stores unicode natively
                arrays[key] = a
        save_npz(self._path(fragment), arrays, manifest)

    def load_latest(self, fragments_in_order) -> Optional[tuple]:
        """→ (fragment_name, registry) for the newest existing snapshot."""
        for fragment in reversed(list(fragments_in_order)):
            p = self._path(fragment)
            if os.path.exists(p):
                arrays, manifest = load_npz(p)
                registry: Dict[str, dict] = {}
                for tname, meta in manifest["tables"].items():
                    rows = {c: arrays[f"{tname}::{c}"] for c in meta["columns"]}
                    registry[tname] = {"rows": rows,
                                       "partition_key": meta["partition_key"]}
                return manifest["fragment"], registry
        return None
