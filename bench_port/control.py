#!/usr/bin/env python3
"""Readings that set a cell's limits: the program over many seeds (the
lower reading of each number compared) and the control over a few (the
upper reading), in one process.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 5

The control is the plain reference put in the engine's place and computed
one precision below the configuration's: float64 money in float32.  Each
run is a whole run of the cell (set-up, a short window at the cell's own
load, the comparison), and prints one JSON line: ``kind`` (``program`` or
``control``), ``seed``, ``correct`` and ``checks``.  Not a run of the
benchmark: no cell runs it.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def control_answer(cell_name: str):
    """``answer(ds)`` for ``cell.run``: the float32 reference."""
    import torch
    from bench_port.harness import spec
    c = spec.Cell(spec.load_benchmark(), cell_name)
    ref_mod, queries = c.module("reference"), c.module("queries")

    def answer(ds):
        ref = ref_mod.Reference(ds, torch.float32)
        return lambda qid, params: ref.run(qid, queries.slots(qid, params))
    return answer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    from bench_port.harness import cell

    def seeds(s):
        return [int(x) for x in s.split(",") if x]
    runs = [("program", s) for s in seeds(args.seeds)]
    runs += [("control", s) for s in seeds(args.control_seeds)]
    for kind, seed in runs:
        answer = control_answer(args.workload) if kind == "control" else None
        try:
            res = cell.run(args.workload, seed, args.seconds, False,
                           answer=answer)
            line = {"kind": kind, "seed": seed, "correct": res["correct"],
                    "attempted": res["attempted"], "failed": res["failed"],
                    "checks": res["checks"]}
        except Exception as exc:   # a control that crashes has failed
            line = {"kind": kind, "seed": seed, "correct": False,
                    "error": f"{type(exc).__name__}: {exc}"}
        print(json.dumps({"reading": line}), flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
