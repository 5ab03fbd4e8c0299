"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

Set-up builds (or loads) the kernels' library, makes the tables on the
device from the seed, registers them with a ``SiriusEngine`` configured by
the cell's configuration file, and runs the mix's warm passes.  The window
is a closed loop with one client: each query goes through
``SiriusEngine.sql(text)`` and its result to the host through
``Table.to_host()``; the next is sent when the last is back.  After the
window the engine is freed and the reference computes, from the same
generated columns, every answer that is compared.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from . import spec, stats
from .traffic import Stream

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class WindowRun:
    """What a per-layer metric reads: the window's queries, counters,
    journal spans and, traced, device intervals."""

    def __init__(self):
        self.records: List[dict] = []   # qid, text, latency_s, ok
        self.window_s = 0.0
        self.counters_before: Dict[str, float] = {}
        self.counters_after: Dict[str, float] = {}
        self.spans: List[dict] = []     # journal spans of the client thread
        self.trace = None               # harness.trace.Trace, traced runs
        self.t0 = self.t1 = 0.0         # window bounds, perf_counter s
        self.column_bytes: Dict[tuple, int] = {}
        self.queries = None             # the configuration's query module

    @property
    def completed(self) -> List[dict]:
        return [r for r in self.records if r["ok"]]

    def delta(self, name: str) -> float:
        return self.counters_after.get(name, 0) - self.counters_before.get(name, 0)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _counters() -> Dict[str, float]:
    from repro_torch.kernels import build
    from repro_torch.observability.metrics import METRICS
    snap = dict(METRICS.snapshot())
    snap["kernel.launches"] = sum(build.launch_counts().values())
    return snap


def _tables(ds):
    from repro_torch.relational.table import Column, Table
    for t, cols in ds.tables.items():
        dicts = ds.dictionaries.get(t, {})
        yield t, Table({c: Column(v, ds.kinds[t][c], dicts.get(c))
                        for c, v in cols.items()})


def _ask(eng, text: str):
    t0 = time.perf_counter()
    try:
        out = eng.sql(text)
        host = out.to_host()
        del out
        return host, None, time.perf_counter() - t0
    except Exception as exc:     # a failed query is counted, not fatal
        return None, f"{type(exc).__name__}: {exc}", time.perf_counter() - t0


class _Stand:
    """Answers in the engine's place (the control): ``sql(text)`` finds
    the query by its text and returns a host result."""

    def __init__(self, answer, queries):
        self.answer = answer
        self.queries = queries
        self.by_text = {}

    def remember(self, qid, params):
        self.by_text[self.queries.text(qid, params)] = (qid, params)

    def sql(self, text):
        return _Host(self.answer(*self.by_text[text]))


class _Host:
    def __init__(self, host):
        self.host = host

    def to_host(self):
        return self.host


def run(name: str, seed: int, seconds: float, trace: bool,
        device: Optional[str] = None, t_start: Optional[float] = None,
        scale: Optional[float] = None, answer=None) -> dict:
    """One run of cell ``name`` → the result line's object.  ``device``
    and ``scale`` are for tests on the CPU; a measured run takes the card
    and the configuration's scale.  ``answer(ds)``, for the control, gives
    a function ``(qid, params) → host result`` that takes the engine's
    place."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    cell = spec.Cell(spec.load_benchmark(), name)
    cfg = cell.config
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{name} needs {cell.chips} CUDA device(s); "
                             f"found {torch.cuda.device_count()}")
        device = "cuda:0"
        torch.cuda.set_device(0)
    dev = torch.device(device)
    scale = cfg["scale"] if scale is None else scale
    setup: Dict[str, float] = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    from repro_torch.core.executor import SiriusEngine
    if cfg["engine"].get("use_kernels") and on_card:
        from repro_torch.kernels import build
        t = time.perf_counter()
        build.lib()
        setup["kernel_library_s"] = time.perf_counter() - t
        if build.build_seconds is not None:
            setup["nvcc_build_s"] = build.build_seconds

    t = time.perf_counter()
    ds = cell.module("datagen").generate(scale, seed, dev)
    sync()
    setup["datagen_s"] = time.perf_counter() - t
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    t = time.perf_counter()
    queries = cell.module("queries")
    if answer is None:
        eng = SiriusEngine(device=dev, **cfg["engine"])
        for tname, table in _tables(ds):
            eng.register(tname, table)
    else:
        eng = _Stand(answer(ds), queries)
    sync()
    setup["register_s"] = time.perf_counter() - t

    stream = Stream(cell.traffic, queries, seed, scale)
    t = time.perf_counter()
    warm = []
    for qid, params in stream.warm():
        if answer is not None:
            eng.remember(qid, params)
        host, err, lat = _ask(eng, queries.text(qid, params))
        warm.append({"qid": qid, "params": params, "host": host,
                     "error": err, "latency_s": lat})
    setup["warm_s"] = time.perf_counter() - t
    setup["tables_bytes"] = ds.nbytes()

    from repro_torch.observability.journal import JOURNAL
    run_ = WindowRun()
    run_.queries = queries
    run_.column_bytes = ds.column_bytes()
    hosts: List[Optional[dict]] = []
    params_of: List[dict] = []
    client = threading.get_ident()
    tracer = None
    if trace:
        from .trace import Trace
        tracer = Trace()
        tracer.__enter__()
    JOURNAL.clear()
    run_.counters_before = _counters()
    gc.collect()
    try:
        marker = tracer.marker() if tracer else None
        if marker is not None:
            marker.__enter__()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        deadline = t0 + seconds
        for qid, params in stream.window():
            if time.perf_counter() >= deadline:
                break
            text = queries.text(qid, params)
            if answer is not None:
                eng.remember(qid, params)
            host, err, lat = _ask(eng, text)
            run_.records.append({"qid": qid, "latency_s": lat,
                                 "ok": err is None, "error": err})
            hosts.append(host)
            params_of.append(params)
        t1 = time.perf_counter()
        if marker is not None:
            marker.__exit__(None, None, None)
    finally:
        if tracer:
            tracer.__exit__(None, None, None)
    run_.t0, run_.t1, run_.window_s = t0, t1, t1 - t0
    run_.counters_after = _counters()
    run_.spans = [e for e in JOURNAL.events()
                  if e["kind"] == "span" and e["tid"] == client]
    run_.trace = tracer
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0

    records = run_.records
    lat = [r["latency_s"] for r in records]
    completed = len(run_.completed)
    result = {"correct": False, "attempted": len(records),
              "failed": len(records) - completed, "metrics": {}}
    if trace:
        for m in cell.metrics("per_layer"):
            value = spec.metric_reader(m["name"])(run_)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"queries_per_s": completed / run_.window_s,
               "query_p95_ms": stats.percentile(lat, 95) * 1e3 if lat else None,
               "setup_s": setup_s}
        for m in cell.metrics("end_to_end"):
            if e2e.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}
    result["device"] = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": 1, "memory_peak_bytes": peak}
    if trace:
        result["device"]["busy_s"] = tracer.busy_seconds(t0, t1)
        result["device"]["window_s"] = run_.window_s
        result["breakdown"] = tracer.breakdown(t0, t1, run_.spans)
    info = {"cell": name, "seed": seed, "card": card_line() if on_card else "cpu",
            "torch": torch.__version__, "setup": setup, "setup_s": setup_s,
            "window_s": run_.window_s, "queries": completed,
            "p50_ms": stats.percentile(lat, 50) * 1e3 if lat else None,
            "memory_peak_bytes": peak,
            "errors": sorted({r["error"] for r in records if r["error"]})[:5]}
    print(__import__("json").dumps({"info": info}), flush=True)

    # the program's state goes before the reference runs
    del eng, tracer
    run_.trace = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks = _check(cell, ds, queries, warm, records, hosts, params_of)
    result["correct"] = (result["failed"] == 0 and checks.pop("compared") > 0
                         and all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    return result


def _check(cell, ds, queries, warm, records, hosts, params_of) -> dict:
    """Compare every answer of the warm pass and of the window with the
    reference → the numbers compared, each with its limit."""
    import torch
    from ..reference.compare import compare

    def log(*a):
        print(*a, file=sys.stderr, flush=True)
    ref = cell.module("reference").Reference(ds)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    todo = [(w["qid"], w["params"], w["host"]) for w in warm if w["host"] is not None]
    todo += [(r["qid"], p, h) for r, p, h in zip(records, params_of, hosts)
             if h is not None]
    wants: Dict[str, dict] = {}
    limits = cell.config["limits"]
    mismatched, worst, worst_at, notes = 0, 0.0, None, []
    t = time.perf_counter()
    for qid, params, got in todo:
        key = queries.text(qid, params)
        if key not in wants:
            wants[key] = ref.run(qid, queries.slots(qid, params))
        mm, err, note = compare(got, wants[key], limits["float_err"])
        mismatched += mm
        if mm and len(notes) < 3:
            notes.append(f"{qid}: {note}")
        if err > worst:
            worst, worst_at = err, qid
    log(f"reference: {len(wants)} distinct answers, {len(todo)} compared, "
        f"{time.perf_counter() - t:.1f} s")
    for n in notes:
        log(f"mismatch {n}")
    if worst_at is not None:
        log(f"widest float gap at {worst_at}")
    return {
        "failed_warm": {"value": sum(w["host"] is None for w in warm), "limit": 0},
        "compared": len(todo),
        "mismatched": {"value": mismatched, "limit": limits["mismatched"]},
        "float_err": {"value": worst, "limit": limits["float_err"]},
    }
