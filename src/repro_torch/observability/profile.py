"""QueryProfile: the per-query EXPLAIN ANALYZE record.

Counterpart of ``repro/observability/profile.py``: the same schema
(``PROFILE_SCHEMA_VERSION`` 1, the same key sets and categories), so the
reference's ``validate_profile`` and ``scripts/profile_diff.py`` read the
port's JSON unchanged.  On the card an operator's ``seconds`` is host wall
clock up to a ``torch.cuda.synchronize`` after the stage, not device time.

Assembled by the executor when a query runs with ``analyze=True`` (or in
the legacy pre-fusion ``profile=True`` mode): per-pipeline operator
entries with wall time and rows in/out, the compile-vs-execute split,
per-query deltas of the engine's cache/kernel/transfer counters, the plan
text, and (for hybrid ``accelerate`` runs) fragment placements.

The JSON export is **versioned and schema-stable**: ``to_json`` always
emits exactly the keys ``validate_profile`` checks, so profiles written by
benchmarks (BENCH_*.json), CI smoke artifacts and ad-hoc EXPLAIN ANALYZE
runs stay diffable across runs — ``diff_profiles`` /
``scripts/profile_diff.py`` is the tool that names the operator that moved.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Dict, List, Optional, Tuple

PROFILE_SCHEMA_VERSION = 1

# every operator entry carries one of these categories (bench_breakdown and
# the schema validator key on the set)
OPERATOR_CATEGORIES = ("scan", "filter", "project", "join", "groupby",
                       "orderby", "fused", "other")

_TOP_KEYS = ("schema_version", "query", "engine", "total_seconds",
             "compile_seconds", "execute_seconds", "pipelines",
             "operator_totals", "metrics", "plan", "fragments")
_OP_KEYS = ("name", "category", "rows_in", "rows_out", "seconds", "attrs")
_PIPELINE_KEYS = ("pid", "source", "deps", "operators")


@dataclasses.dataclass
class OperatorProfile:
    """One executed operator (or fused region) inside a pipeline."""
    name: str
    category: str
    rows_in: int
    rows_out: int
    seconds: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "category": self.category,
                "rows_in": int(self.rows_in), "rows_out": int(self.rows_out),
                "seconds": float(self.seconds), "attrs": dict(self.attrs)}


@dataclasses.dataclass
class PipelineProfile:
    """One executed pipeline: source description, dependencies, operators."""
    pid: int
    source: str
    deps: List[int]
    operators: List[OperatorProfile] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"pid": self.pid, "source": self.source,
                "deps": list(self.deps),
                "operators": [o.to_dict() for o in self.operators]}


@dataclasses.dataclass
class QueryProfile:
    query: Optional[str]
    engine: Dict[str, Any]
    total_seconds: float
    compile_seconds: float
    execute_seconds: float
    pipelines: List[PipelineProfile]
    operator_totals: Dict[str, float]
    metrics: Dict[str, float]
    plan: str
    fragments: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    # -- export --------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": PROFILE_SCHEMA_VERSION,
            "query": self.query,
            "engine": dict(self.engine),
            "total_seconds": float(self.total_seconds),
            "compile_seconds": float(self.compile_seconds),
            "execute_seconds": float(self.execute_seconds),
            "pipelines": [p.to_dict() for p in self.pipelines],
            "operator_totals": {k: float(v)
                                for k, v in sorted(self.operator_totals.items())},
            "metrics": {k: v for k, v in sorted(self.metrics.items())},
            "plan": self.plan,
            "fragments": list(self.fragments),
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QueryProfile":
        errors = validate_profile(d)
        if errors:
            raise ValueError("invalid profile: " + "; ".join(errors))
        return cls(
            query=d["query"], engine=d["engine"],
            total_seconds=d["total_seconds"],
            compile_seconds=d["compile_seconds"],
            execute_seconds=d["execute_seconds"],
            pipelines=[PipelineProfile(
                pid=p["pid"], source=p["source"], deps=list(p["deps"]),
                operators=[OperatorProfile(**o) for o in p["operators"]])
                for p in d["pipelines"]],
            operator_totals=dict(d["operator_totals"]),
            metrics=dict(d["metrics"]), plan=d["plan"],
            fragments=list(d["fragments"]))

    @classmethod
    def from_json(cls, s: str) -> "QueryProfile":
        return cls.from_dict(json.loads(s))

    # -- pretty printer ------------------------------------------------------
    def pretty(self) -> str:
        """Annotated EXPLAIN ANALYZE rendering: the optimized plan tree,
        then each executed pipeline with per-operator wall time, rows and
        region annotations (cache hit, probe mode, estimated FLOPs/bytes)."""
        ms = 1e3
        lines = [f"EXPLAIN ANALYZE  "
                 f"(total {self.total_seconds * ms:.2f} ms = "
                 f"compile {self.compile_seconds * ms:.2f} ms + "
                 f"execute {self.execute_seconds * ms:.2f} ms)"]
        if self.query:
            lines.append(f"query: {' '.join(self.query.split())[:120]}")
        if self.plan:
            lines.append("plan:")
            lines.extend("  " + ln for ln in self.plan.splitlines())
        for p in self.pipelines:
            dep = f" deps={p.deps}" if p.deps else ""
            lines.append(f"pipeline {p.pid} <- {p.source}{dep}")
            for op in p.operators:
                note = ""
                if op.attrs:
                    parts = []
                    for k in ("cache_hit", "mode", "est_flops", "est_bytes"):
                        if k in op.attrs:
                            v = op.attrs[k]
                            parts.append(f"{k}={v:.3g}" if isinstance(v, float)
                                         else f"{k}={v}")
                    if parts:
                        note = "  [" + " ".join(parts) + "]"
                lines.append(
                    f"  {op.name:<42} {op.seconds * ms:9.3f} ms  "
                    f"rows {op.rows_in:>9} -> {op.rows_out:>9}{note}")
        if self.fragments:
            lines.append("fragments:")
            for f in self.fragments:
                lines.append(f"  frag {f.get('fid')} [{f.get('placement')}] "
                             f"rels={f.get('rels')} "
                             f"{f.get('seconds', 0.0) * ms:.2f} ms")
        if self.operator_totals:
            tot = ", ".join(f"{k}={v * ms:.2f}ms"
                            for k, v in sorted(self.operator_totals.items(),
                                               key=lambda kv: -kv[1]))
            lines.append(f"operator totals: {tot}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# builder (filled in by the executor during an analyzed run)
# ---------------------------------------------------------------------------


class ProfileBuilder:
    """Mutable per-query collector; thread-safe (worker threads append)."""

    def __init__(self, query: Optional[str] = None,
                 engine: Optional[Dict[str, Any]] = None):
        self.query = query
        self.engine = dict(engine or {})
        self.plan_text = ""
        self.fragments: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._pipelines: List[PipelineProfile] = []

    def start_pipeline(self, source: str, deps: List[int]) -> PipelineProfile:
        with self._lock:
            rec = PipelineProfile(len(self._pipelines), source, list(deps))
            self._pipelines.append(rec)
            return rec

    def add_operator(self, rec: PipelineProfile, name: str, category: str,
                     rows_in: int, rows_out: int, seconds: float,
                     **attrs: Any) -> OperatorProfile:
        op = OperatorProfile(name, category, int(rows_in), int(rows_out),
                             float(seconds), dict(attrs))
        with self._lock:
            rec.operators.append(op)
        return op

    def finalize(self, total_seconds: float, compile_seconds: float,
                 metrics: Dict[str, float]) -> QueryProfile:
        totals: Dict[str, float] = {}
        with self._lock:
            pipelines = list(self._pipelines)
        for p in pipelines:
            for op in p.operators:
                totals[op.category] = totals.get(op.category, 0.0) + op.seconds
        compile_seconds = min(max(compile_seconds, 0.0), total_seconds)
        return QueryProfile(
            query=self.query, engine=self.engine,
            total_seconds=float(total_seconds),
            compile_seconds=float(compile_seconds),
            execute_seconds=float(max(total_seconds - compile_seconds, 0.0)),
            pipelines=pipelines, operator_totals=totals, metrics=dict(metrics),
            plan=self.plan_text, fragments=list(self.fragments))


# ---------------------------------------------------------------------------
# schema validation (CI smoke + golden tests key on this)
# ---------------------------------------------------------------------------


def validate_profile(d: Any) -> List[str]:
    """Structural schema check → list of error strings (empty = valid).

    Checks key sets, types, category vocabulary, non-negative rows, and
    the timing invariants the acceptance contract names: every duration
    ≥ 0, compile + execute ≤ total, and per-operator times summing to
    ≤ total query wall time (pipelines are serialized under analyze, so
    operator wall clocks cannot overlap)."""
    errors: List[str] = []
    if not isinstance(d, dict):
        return [f"profile must be a dict, got {type(d).__name__}"]
    missing = [k for k in _TOP_KEYS if k not in d]
    extra = [k for k in d if k not in _TOP_KEYS]
    if missing:
        errors.append(f"missing top-level keys: {missing}")
    if extra:
        errors.append(f"unknown top-level keys: {extra}")
    if d.get("schema_version") != PROFILE_SCHEMA_VERSION:
        errors.append(f"schema_version {d.get('schema_version')!r} != "
                      f"{PROFILE_SCHEMA_VERSION}")
    if missing:
        return errors

    for key in ("total_seconds", "compile_seconds", "execute_seconds"):
        v = d[key]
        if not isinstance(v, (int, float)) or v < 0:
            errors.append(f"{key} must be a non-negative number, got {v!r}")
    if not errors:
        if d["compile_seconds"] + d["execute_seconds"] > \
                d["total_seconds"] * 1.001 + 1e-9:
            errors.append("compile_seconds + execute_seconds exceeds "
                          "total_seconds")

    if not isinstance(d["engine"], dict):
        errors.append("engine must be a dict")
    if d["query"] is not None and not isinstance(d["query"], str):
        errors.append("query must be a string or null")
    if not isinstance(d["plan"], str):
        errors.append("plan must be a string")
    if not isinstance(d["fragments"], list):
        errors.append("fragments must be a list")
    if not isinstance(d["metrics"], dict):
        errors.append("metrics must be a dict")
    else:
        for k, v in d["metrics"].items():
            if not isinstance(v, (int, float)):
                errors.append(f"metric {k!r} must be numeric, got {v!r}")
    if not isinstance(d["operator_totals"], dict):
        errors.append("operator_totals must be a dict")
    else:
        for k, v in d["operator_totals"].items():
            if k not in OPERATOR_CATEGORIES:
                errors.append(f"unknown operator category {k!r}")
            if not isinstance(v, (int, float)) or v < 0:
                errors.append(f"operator_totals[{k!r}] must be >= 0")

    op_sum = 0.0
    if not isinstance(d["pipelines"], list):
        errors.append("pipelines must be a list")
        return errors
    for p in d["pipelines"]:
        if not isinstance(p, dict) or sorted(p) != sorted(_PIPELINE_KEYS):
            errors.append(f"pipeline keys must be {_PIPELINE_KEYS}, "
                          f"got {sorted(p) if isinstance(p, dict) else p!r}")
            continue
        if not isinstance(p["pid"], int) or not isinstance(p["source"], str):
            errors.append(f"pipeline {p.get('pid')!r}: bad pid/source types")
        for op in p["operators"]:
            if not isinstance(op, dict) or sorted(op) != sorted(_OP_KEYS):
                errors.append(f"operator keys must be {_OP_KEYS}, got "
                              f"{sorted(op) if isinstance(op, dict) else op!r}")
                continue
            if op["category"] not in OPERATOR_CATEGORIES:
                errors.append(f"operator {op['name']!r}: unknown category "
                              f"{op['category']!r}")
            for key in ("rows_in", "rows_out"):
                if not isinstance(op[key], int) or op[key] < 0:
                    errors.append(f"operator {op['name']!r}: {key} must be a "
                                  f"non-negative int")
            if not isinstance(op["seconds"], (int, float)) or op["seconds"] < 0:
                errors.append(f"operator {op['name']!r}: seconds must be >= 0")
            else:
                op_sum += op["seconds"]
            if not isinstance(op["attrs"], dict):
                errors.append(f"operator {op['name']!r}: attrs must be a dict")
    if not errors and isinstance(d["total_seconds"], (int, float)):
        if op_sum > d["total_seconds"] * 1.001 + 1e-9:
            errors.append(f"per-operator seconds sum to {op_sum:.6f} > "
                          f"total_seconds {d['total_seconds']:.6f}")
    return errors


# ---------------------------------------------------------------------------
# profile diffing (scripts/profile_diff.py is the CLI wrapper)
# ---------------------------------------------------------------------------


def _operator_table(profile: Dict[str, Any]) -> Dict[str, float]:
    """Flatten a profile to {qualified operator name: seconds} plus the
    category totals and the query total — the comparable units of a diff."""
    out: Dict[str, float] = {"total": float(profile["total_seconds"]),
                             "compile": float(profile["compile_seconds"])}
    for cat, s in profile.get("operator_totals", {}).items():
        out[f"category:{cat}"] = float(s)
    for p in profile.get("pipelines", []):
        for i, op in enumerate(p.get("operators", [])):
            out[f"p{p['pid']}/{i}:{op['name']}"] = float(op["seconds"])
    return out


def diff_profiles(old: Dict[str, Any], new: Dict[str, Any],
                  threshold: float = 1.5,
                  min_delta_s: float = 0.002) -> Tuple[List[str], List[str]]:
    """Compare two profile dicts → (regressions, report_lines).

    An entry regresses when it slowed by more than ``threshold``× AND by
    more than ``min_delta_s`` wall seconds (both gates, so noise on
    microsecond operators never pages anyone).  The report names every
    operator/phase that moved in either direction.
    """
    a, b = _operator_table(old), _operator_table(new)
    regressions: List[str] = []
    report: List[str] = []
    for key in sorted(set(a) | set(b)):
        sa, sb = a.get(key, 0.0), b.get(key, 0.0)
        delta = sb - sa
        if abs(delta) < min_delta_s:
            continue
        ratio = (sb / sa) if sa > 0 else float("inf")
        line = (f"{key}: {sa * 1e3:.2f} ms -> {sb * 1e3:.2f} ms "
                f"({'+' if delta >= 0 else ''}{delta * 1e3:.2f} ms, "
                f"{ratio:.2f}x)")
        if delta > 0 and ratio > threshold:
            regressions.append(f"REGRESSION {line}")
            report.append(f"REGRESSION {line}")
        else:
            report.append(("improved   " if delta < 0 else "moved      ")
                          + line)
    return regressions, report
