#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
reference, beside its limit (also the last lines of standard error).
Without a card, or with JAX or the JAX package loaded, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches at fixed paths inside the checkout; the journal's file sink off
for var in ("REPRO_JOURNAL_SINK", "REPRO_JOURNAL_DISABLE"):
    os.environ.pop(var, None)
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_port" / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "bench_port" / "inductor")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_port.harness import cell
    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    found = cell.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
