"""Dry run of the production cells: per-shard memory, traffic, FLOPs and
collective bytes, with no card — counterpart of ``repro/launch/dryrun.py``.

Per SQL cell this module builds the fragment for the 256-shard mesh (or
2 x 256), makes its inputs as fake tensors on ``cuda`` (shapes and dtypes,
nothing allocated) and runs it once under ``analysis.OpCounter`` on a
``CountingMesh``.  The run takes the card's branches; the counts are the
eager run's.  Every figure in a record is per shard: what one card of a
256-card deployment would read, send and hold (``n_chips`` is the mesh's
size; the shards of a sharded tensor are its leading axis).

Per model cell (each configuration's shapes, on the 16 x 16 and
2 x 16 x 16 meshes) ``model_dryrun.lower_cell`` builds one shard's program
and ``model_dryrun.analyze`` counts it on ``meta`` tensors: the reference's
record (``model_params``, ``active_params``, ``seq_len``, ``global_batch``,
``kind``, ``flops_per_device`` and ``flops_detail``, bytes accessed,
collective bytes by kind, ``memory``, ``n_chips``), ``fits_card`` against
the card's memory in place of ``fits_16gb_v5e``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --arch sirius-tpch --shape q3_sf100 --mesh both
  python -m repro_torch.launch.dryrun --sweep            # every cell, both meshes
  python -m repro_torch.launch.dryrun --arch sirius-tpch --sweep
Records go to ``build/dryrun/`` (``--outdir``).  Neither needs a card; on
one, the model records are the same, the SQL ones take its branches.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .analysis import CountingMesh, OpCounter, fake_cuda, nbytes
from .sql_dryrun import Spec, lower_sql_fragment

SQL_ARCH = "sirius-tpch"
# an H100 SXM's memory, for a record made without a card
STATED_CARD_BYTES = 80 * 10**9
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun")


def card_memory() -> dict:
    """The budget a shard must fit: the card's memory where there is one,
    else the stated 80 GB of an H100."""
    if torch.cuda.is_available():
        p = torch.cuda.get_device_properties(0)
        return {"card_bytes": int(p.total_memory), "card": p.name}
    return {"card_bytes": STATED_CARD_BYTES, "card": "stated: H100 80 GB"}


def make_inputs(specs, device) -> tuple:
    """Empty tensors of the specs' shapes and dtypes on ``device``."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device)
                    if isinstance(s, Spec) else s, specs)


def _bytes_per_shard(outputs, n: int) -> float:
    """What one shard holds of a fragment's outputs: a tensor whose leading
    axis is the mesh's is sharded, any other is every shard's (a psum's
    result, a count)."""
    return sum(nbytes(t) / n if t.dim() and t.shape[0] == n else nbytes(t)
               for t in outputs)


def analyze(fragment, specs, mesh) -> dict:
    """Run ``fragment(mesh, *inputs)`` once on fake ``cuda`` tensors of
    ``specs`` → per-shard bytes accessed, element operations, collective
    bytes by kind and memory (the reference's record keys where the
    meaning is the same)."""
    counting = CountingMesh.like(mesh)
    n = mesh.size
    with fake_cuda() as dev:
        args = make_inputs(specs, dev)
        arg_bytes = sum(nbytes(t) for t in tree_leaves(args))
        with OpCounter() as ops:
            out = fragment(counting, *args)
        out_bytes = _bytes_per_shard(tree_leaves(out), n)
    del out, args
    # the peak counts what the run allocated (outputs included); the
    # arguments are held the whole time
    resident = (arg_bytes + ops.peak) / n
    mem = {"argument_bytes": arg_bytes / n, "output_bytes": out_bytes,
           "temp_bytes": resident - arg_bytes / n - out_bytes,
           "resident_bytes_per_chip": resident}
    budget = card_memory()
    mem.update(budget, fits_card=bool(resident <= budget["card_bytes"]))
    return {"bytes_accessed_per_device": ops.bytes_accessed / n,
            "element_ops_per_device": ops.element_ops / n,
            "aten_ops": ops.ops,
            "bytes_by_op_per_device": {
                op: b / n for op, (_, b) in sorted(
                    ops.by_op.items(), key=lambda kv: -kv[1][1])},
            "collective_bytes_per_device": counting.collective_bytes(),
            "memory": mem, "n_chips": n}


def lower_cell(arch: str, shape_name: str, multi_pod: bool, **kw):
    """A model cell's shard program → (cfg, shape, cell):
    ``model_dryrun.lower_cell``."""
    from .model_dryrun import lower_cell as lower_model_cell
    return lower_model_cell(arch, shape_name, multi_pod, **kw)


def _metadata(cfg, shape) -> dict:
    return {"model_params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "kind": shape.kind}


def cell_metadata(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """A model cell's record metadata, as ``run_cell`` writes it."""
    from ..configs.base import get_config
    from .mesh import make_production_mesh
    cfg = get_config(arch)
    shape = next(s for s in cfg.shapes() if s.name == shape_name)
    n = make_production_mesh(multi_pod=multi_pod, device="meta").size
    return {**_metadata(cfg, shape), "n_chips": n}


def model_record(arch: str, shape_name: str, multi_pod: bool, **kw) -> dict:
    """A model cell's record fields (``lower_cell`` then
    ``model_dryrun.analyze``); ``kw`` goes to ``lower_cell``."""
    from .model_dryrun import analyze as analyze_model
    cfg, shape, cell = lower_cell(arch, shape_name, multi_pod, **kw)
    return {**_metadata(cfg, shape), **analyze_model(cell)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             outdir: Optional[str] = None) -> dict:
    """One cell's record (printed, and written to ``outdir`` as JSON)."""
    from .mesh import make_sql_mesh
    mesh = make_sql_mesh(multi_pod=multi_pod) if arch == SQL_ARCH else None
    mesh_name = ("x".join(str(s) for s in mesh.shape) if mesh is not None
                 else ("2x16x16" if multi_pod else "16x16"))
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "ok"}
    try:
        t0 = time.perf_counter()
        if arch == SQL_ARCH:
            fragment, specs, extra = lower_sql_fragment(shape_name, multi_pod,
                                                        mesh=mesh)
            record.update(extra)
            record.update(analyze(fragment, specs, mesh))
        else:
            record.update(model_record(arch, shape_name, multi_pod))
        record["trace_time_s"] = round(time.perf_counter() - t0, 2)
        mem = record["memory"]
        coll = record["collective_bytes_per_device"]
        flops = (f"flops/shard={record['flops_per_device']:.4e}  "
                 if "flops_per_device" in record else "")
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK  {flops}"
              f"resident/shard={mem['resident_bytes_per_chip'] / 2**30:.3f}GiB "
              f"fits_card={mem['fits_card']}  "
              f"accessed/shard={record['bytes_accessed_per_device']:.4e}B  "
              f"collectives/shard={coll['total']:.4e}B "
              f"{ {k: v for k, v in coll.items() if k != 'total'} }")
    except Exception as e:  # noqa: BLE001 — one cell fails, the sweep goes on
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"FAILED {record['error']}")
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_name}.json".replace("/", "_")
        with open(os.path.join(outdir, fname), "w") as f:
            json.dump(record, f, indent=1, default=str)
    return record


def _run(cell) -> dict:
    return run_cell(*cell[:3], outdir=cell[3])


SQL_CELLS = ("q3_sf100", "q3pt_sf100", "q1_sf100", "q3c_sf100",
             "q3ptc_sf100")


def all_cells():
    """Every (arch, shape) cell: each model configuration's shapes, then
    the SQL fragments."""
    from ..configs.base import all_configs
    cells = []
    for name, cfg in sorted(all_configs().items()):
        cells += [(name, s.name) for s in cfg.shapes()]
    cells += [(SQL_ARCH, s) for s in SQL_CELLS]
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--outdir", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--jobs", type=int, default=min(4, os.cpu_count() or 1),
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}
    if args.sweep:
        todo = [c for c in all_cells() if args.arch in (None, c[0])]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --sweep")
        todo = [(args.arch, args.shape)]
    status = {}
    t0 = time.perf_counter()
    cells = [(arch, shape, mp, args.outdir) for arch, shape in todo
             for mp in meshes[args.mesh]]
    if args.jobs > 1 and len(cells) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(args.jobs, multiprocessing.get_context(
                "spawn")) as pool:
            records = list(pool.map(_run, cells))
    else:
        records = [_run(c) for c in cells]
    for rec in records:
        status[rec["status"]] = status.get(rec["status"], 0) + 1
    print(f"[dryrun] done; {status} in {time.perf_counter() - t0:.1f} s")
    return 1 if status.get("error") else 0


if __name__ == "__main__":
    raise SystemExit(main())
