"""Substrait-style wire format: producer (``emit``) and consumer (``ingest``)
— counterpart of ``repro/substrait/wire.py``, byte for byte.

The wire is a plain-JSON analogue of a Substrait plan message:

.. code-block:: text

    {
      "version":       {"majorNumber": 0, "minorNumber": 54, ...},
      "extensionUris": [{"extensionUriAnchor": 1, "uri": ".../*.yaml"}, ...],
      "extensions":    [{"extensionFunction": {"extensionUriReference": 1,
                                               "functionAnchor": 7,
                                               "name": "add"}}, ...],
      "schemas":       {"lineitem": {"columns": [{"name", "kind", "dtype",
                                                  "dictionary"}, ...]}},
      "relations":     [{"root": {"input": <rel>, "names": [...]}}]
    }

Every rel is a single-key object (``{"read": {...}}``, ``{"join": {...}}``,
…) and every non-leaf expression is a ``scalarFunction`` whose
``functionReference`` resolves through the ``extensions`` block into the
function registry — ingesting a plan that references a function or rel this
engine does not know fails with an actionable ``SubstraitError`` instead of
a ``KeyError``, which is the negotiation half of the drop-in contract.

Determinism: ``emit`` assigns extension anchors by sorted (group, name), so
emit → ingest → emit is byte-identical under ``wire_bytes`` (the canonical
serialization the golden files in ``tests/golden/substrait`` are stored in).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Set

from ..core.plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, Rel, ScalarSubquery, SetRel, SortRel, WindowRel, walk_deep,
)
from ..relational.aggregate import AggSpec
from ..relational.expressions import (
    Between, BinOp, Case, Cast, Col, Expr, ExtractYear, InList, Like, Lit,
    StartsWith, Substr, UnOp, walk_expr,
)
from ..relational.sort import SortKey
from .registry import (
    BINOP_TO_FUNCTION, EXTENSION_URIS, FUNCTION_TO_BINOP, FUNCTIONS,
)

WIRE_MAJOR = 0
WIRE_MINOR = 54
PRODUCER = "repro-substrait/0.1"

_KIND_DTYPE = {
    "numeric": "fp64",
    "string": "dictionary<i32,string>",
    "date": "date32[day]",
    "bool": "bool",
}

_REL_KEYS = ("read", "filter", "project", "join", "aggregate", "sort",
             "fetch", "exchange", "set", "window")

_JOIN_TYPES = {
    "inner": "JOIN_TYPE_INNER", "left": "JOIN_TYPE_LEFT",
    "semi": "JOIN_TYPE_LEFT_SEMI", "anti": "JOIN_TYPE_LEFT_ANTI",
    "mark": "JOIN_TYPE_LEFT_MARK",
}
_JOIN_TYPES_BACK = {v: k for k, v in _JOIN_TYPES.items()}

_SORT_ASC = "SORT_DIRECTION_ASC_NULLS_FIRST"
_SORT_DESC = "SORT_DIRECTION_DESC_NULLS_LAST"


class SubstraitError(ValueError):
    """Wire-format violation: unknown rel/function, bad reference, missing
    field.  Always carries enough context to locate the offending node."""


# ---------------------------------------------------------------------------
# canonical serialization
# ---------------------------------------------------------------------------


def wire_bytes(wire: Dict[str, Any]) -> bytes:
    """The canonical byte serialization (what golden files store): compact,
    key-sorted JSON + trailing newline."""
    return (json.dumps(wire, sort_keys=True, separators=(",", ":"),
                       ensure_ascii=True) + "\n").encode("utf-8")


# ---------------------------------------------------------------------------
# producer
# ---------------------------------------------------------------------------


def _used_functions(plan: Rel) -> Set[str]:
    used: Set[str] = set()

    def visit_expr(e: Expr) -> None:
        for node in walk_expr(e):
            if isinstance(node, BinOp):
                used.add(BINOP_TO_FUNCTION[node.op])
            elif isinstance(node, UnOp):
                used.add("not" if node.op == "not" else "negate")
            elif isinstance(node, Between):
                used.add("between")
            elif isinstance(node, InList):
                used.add("index_in")
            elif isinstance(node, Like):
                used.add("like")
            elif isinstance(node, StartsWith):
                used.add("starts_with")
            elif isinstance(node, Case):
                used.add("if_then")
            elif isinstance(node, ExtractYear):
                used.add("extract_year")
            elif isinstance(node, Substr):
                used.add("substring")
            elif isinstance(node, Cast):
                used.add("cast")

    from ..core.plan import rel_exprs
    for rel in walk_deep(plan):
        for e in rel_exprs(rel):
            visit_expr(e)
        if isinstance(rel, AggregateRel):
            for a in rel.aggs:
                used.add(a.fn)
        elif isinstance(rel, WindowRel):
            used.add(rel.func)
    return used


class _Emitter:
    def __init__(self, anchors: Dict[str, int]):
        self.anchors = anchors

    # -- expressions -------------------------------------------------------
    def fn(self, name: str, args: List[Any],
           options: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        node: Dict[str, Any] = {
            "functionReference": self.anchors[name],
            "arguments": args,
        }
        if options:
            node["options"] = options
        return {"scalarFunction": node}

    def expr(self, e: Expr) -> Dict[str, Any]:
        if isinstance(e, Col):
            return {"selection": {"column": e.name}}
        if isinstance(e, Lit):
            return {"literal": {"value": e.value, "kind": e.kind}}
        if isinstance(e, ScalarSubquery):
            return {"subquery": {"input": self.rel(e.plan),
                                 "column": e.column}}
        if isinstance(e, BinOp):
            return self.fn(BINOP_TO_FUNCTION[e.op],
                           [self.expr(e.left), self.expr(e.right)])
        if isinstance(e, UnOp):
            return self.fn("not" if e.op == "not" else "negate",
                           [self.expr(e.operand)])
        if isinstance(e, Between):
            return self.fn("between", [self.expr(e.operand),
                                       self.expr(e.lo), self.expr(e.hi)])
        if isinstance(e, InList):
            return self.fn("index_in", [self.expr(e.operand)],
                           {"values": list(e.values), "negate": e.negate})
        if isinstance(e, Like):
            return self.fn("like", [self.expr(e.operand)],
                           {"pattern": e.pattern, "negate": e.negate})
        if isinstance(e, StartsWith):
            return self.fn("starts_with", [self.expr(e.operand)],
                           {"prefix": e.prefix, "negate": e.negate})
        if isinstance(e, Case):
            args = []
            for c, v in e.whens:
                args.append(self.expr(c))
                args.append(self.expr(v))
            args.append(self.expr(e.default))
            return self.fn("if_then", args)
        if isinstance(e, ExtractYear):
            return self.fn("extract_year", [self.expr(e.operand)])
        if isinstance(e, Substr):
            return self.fn("substring", [self.expr(e.operand)],
                           {"start": e.start, "length": e.length})
        if isinstance(e, Cast):
            return self.fn("cast", [self.expr(e.operand)],
                           {"dtype": e.dtype})
        raise SubstraitError(f"cannot emit expression {type(e).__name__}")

    def _opt_expr(self, e: Optional[Expr]) -> Optional[Dict[str, Any]]:
        return None if e is None else self.expr(e)

    def _sorts(self, keys: List[SortKey]) -> List[Dict[str, Any]]:
        return [{"field": k.name,
                 "direction": _SORT_ASC if k.ascending else _SORT_DESC}
                for k in keys]

    # -- relations ---------------------------------------------------------
    def rel(self, r: Rel) -> Dict[str, Any]:
        if isinstance(r, ReadRel):
            return {"read": {
                "table": r.table,
                "columns": list(r.columns) if r.columns is not None else None,
                "filter": self._opt_expr(r.filter),
            }}
        if isinstance(r, FilterRel):
            return {"filter": {"input": self.rel(r.input),
                               "condition": self.expr(r.condition)}}
        if isinstance(r, ProjectRel):
            return {"project": {
                "input": self.rel(r.input),
                "expressions": [{"name": n, "expr": self.expr(e)}
                                for n, e in r.exprs],
                "keepInput": r.keep_input,
            }}
        if isinstance(r, JoinRel):
            return {"join": {
                "probe": self.rel(r.probe),
                "build": self.rel(r.build),
                "probeKeys": list(r.probe_keys),
                "buildKeys": list(r.build_keys),
                "type": _JOIN_TYPES[r.how],
                "markName": r.mark_name,
                "postFilter": self._opt_expr(r.post_filter),
            }}
        if isinstance(r, AggregateRel):
            return {"aggregate": {
                "input": self.rel(r.input),
                "groupings": list(r.group_keys),
                "measures": [{
                    "functionReference": self.anchors[a.fn],
                    "argument": self._opt_expr(a.expr),
                    "name": a.name,
                } for a in r.aggs],
                "having": self._opt_expr(r.having),
            }}
        if isinstance(r, SortRel):
            return {"sort": {"input": self.rel(r.input),
                             "sorts": self._sorts(r.keys),
                             "limit": r.limit}}
        if isinstance(r, FetchRel):
            return {"fetch": {"input": self.rel(r.input), "count": r.count}}
        if isinstance(r, ExchangeRel):
            return {"exchange": {"input": self.rel(r.input), "kind": r.kind,
                                 "keys": list(r.keys)}}
        if isinstance(r, SetRel):
            return {"set": {"inputs": [self.rel(p) for p in r.operands],
                            "op": r.op}}
        if isinstance(r, WindowRel):
            return {"window": {
                "input": self.rel(r.input),
                "partitionKeys": list(r.partition_keys),
                "orderKeys": self._sorts(r.order_keys),
                "functionReference": self.anchors[r.func],
                "argument": r.arg,
                "name": r.name,
            }}
        raise SubstraitError(f"cannot emit relation {type(r).__name__}")


def emit(plan: Rel, catalog=None) -> Dict[str, Any]:
    """Serialize a plan into the Substrait-style wire dict.

    ``catalog`` (a ``repro_torch.sql.Catalog``) contributes the schema blocks for
    the base tables the plan reads and the root output names; without one
    the wire simply carries empty ``schemas``/``names``.
    """
    used = sorted(_used_functions(plan),
                  key=lambda n: (FUNCTIONS[n], n))
    anchors = {name: i + 1 for i, name in enumerate(used)}

    groups = sorted({FUNCTIONS[n] for n in used})
    uri_anchor = {g: i + 1 for i, g in enumerate(groups)}
    extension_uris = [{"extensionUriAnchor": uri_anchor[g],
                       "uri": EXTENSION_URIS[g]} for g in groups]
    extensions = [{"extensionFunction": {
        "extensionUriReference": uri_anchor[FUNCTIONS[n]],
        "functionAnchor": anchors[n],
        "name": n,
    }} for n in used]

    schemas: Dict[str, Any] = {}
    if catalog is not None:
        tables = sorted({r.table for r in walk_deep(plan)
                         if isinstance(r, ReadRel)
                         and catalog.has_table(r.table)})
        for t in tables:
            schemas[t] = {"columns": [
                {"name": c, "kind": k, "dtype": _KIND_DTYPE[k],
                 "dictionary": k == "string"}
                for c, k in catalog.schema[t].items()]}

    names: List[str] = []
    if catalog is not None:
        try:
            from ..optimizer.stats import rel_columns
            names = list(rel_columns(plan, catalog))
        except Exception:  # noqa: BLE001 — names are advisory
            names = []

    root = _Emitter(anchors).rel(plan)
    return {
        "version": {"majorNumber": WIRE_MAJOR, "minorNumber": WIRE_MINOR,
                    "patchNumber": 0, "producer": PRODUCER},
        "extensionUris": extension_uris,
        "extensions": extensions,
        "schemas": schemas,
        "relations": [{"root": {"input": root, "names": names}}],
    }


# ---------------------------------------------------------------------------
# consumer
# ---------------------------------------------------------------------------


class _Ingester:
    def __init__(self, functions: Dict[int, str]):
        self.functions = functions   # anchor -> registry name

    def _function(self, d: Dict[str, Any], path: str) -> str:
        ref = d.get("functionReference")
        if ref not in self.functions:
            raise SubstraitError(
                f"{path}: functionReference {ref!r} does not resolve to a "
                f"declared extension function (declared anchors: "
                f"{sorted(self.functions)})")
        return self.functions[ref]

    # -- expressions -------------------------------------------------------
    def expr(self, d: Any, path: str) -> Expr:
        if not isinstance(d, dict) or len(d) != 1:
            raise SubstraitError(
                f"{path}: expected a single-key expression object, got "
                f"{type(d).__name__}")
        key, body = next(iter(d.items()))
        if key == "selection":
            return Col(self._field(body, "column", path))
        if key == "literal":
            if "value" not in body:
                raise SubstraitError(f"{path}: literal without 'value'")
            return Lit(body["value"], body.get("kind"))
        if key == "subquery":
            return ScalarSubquery(
                self.rel(self._field(body, "input", path), path + ".subquery"),
                self._field(body, "column", path))
        if key != "scalarFunction":
            raise SubstraitError(
                f"{path}: unknown expression type {key!r} (expected "
                f"selection | literal | subquery | scalarFunction)")
        name = self._function(body, path)
        args = [self.expr(a, f"{path}.{name}[{i}]")
                for i, a in enumerate(body.get("arguments", []))]
        opts = body.get("options", {})

        def arity(n: int) -> None:
            if len(args) != n:
                raise SubstraitError(
                    f"{path}: function {name!r} expects {n} argument(s), "
                    f"got {len(args)}")

        if name in FUNCTION_TO_BINOP:
            arity(2)
            return BinOp(FUNCTION_TO_BINOP[name], args[0], args[1])
        if name == "not":
            arity(1)
            return UnOp("not", args[0])
        if name == "negate":
            arity(1)
            return UnOp("-", args[0])
        if name == "between":
            arity(3)
            return Between(args[0], args[1], args[2])
        if name == "index_in":
            arity(1)
            return InList(args[0], list(self._field(opts, "values", path)),
                          bool(opts.get("negate", False)))
        if name == "like":
            arity(1)
            return Like(args[0], self._field(opts, "pattern", path),
                        bool(opts.get("negate", False)))
        if name == "starts_with":
            arity(1)
            return StartsWith(args[0], self._field(opts, "prefix", path),
                              bool(opts.get("negate", False)))
        if name == "if_then":
            if len(args) < 3 or len(args) % 2 == 0:
                raise SubstraitError(
                    f"{path}: if_then expects pairs + default "
                    f"(odd arity >= 3), got {len(args)}")
            whens = [(args[i], args[i + 1])
                     for i in range(0, len(args) - 1, 2)]
            return Case(whens, args[-1])
        if name == "extract_year":
            arity(1)
            return ExtractYear(args[0])
        if name == "substring":
            arity(1)
            return Substr(args[0], int(self._field(opts, "start", path)),
                          int(self._field(opts, "length", path)))
        if name == "cast":
            arity(1)
            return Cast(args[0], self._field(opts, "dtype", path))
        raise SubstraitError(
            f"{path}: function {name!r} is declared but is not a scalar "
            f"function this consumer can build an expression from")

    def _opt_expr(self, d: Any, path: str) -> Optional[Expr]:
        return None if d is None else self.expr(d, path)

    @staticmethod
    def _field(body: Any, name: str, path: str) -> Any:
        if not isinstance(body, dict) or name not in body:
            raise SubstraitError(f"{path}: missing required field {name!r}")
        return body[name]

    def _sorts(self, items: Any, path: str) -> List[SortKey]:
        out = []
        for i, s in enumerate(items):
            direction = self._field(s, "direction", f"{path}[{i}]")
            if direction not in (_SORT_ASC, _SORT_DESC):
                raise SubstraitError(
                    f"{path}[{i}]: unknown sort direction {direction!r}")
            out.append(SortKey(self._field(s, "field", f"{path}[{i}]"),
                               direction == _SORT_ASC))
        return out

    # -- relations ---------------------------------------------------------
    def rel(self, d: Any, path: str) -> Rel:
        if not isinstance(d, dict) or len(d) != 1:
            raise SubstraitError(
                f"{path}: expected a single-key relation object, got "
                f"{d!r}" if not isinstance(d, dict) else
                f"{path}: relation object must have exactly one key, got "
                f"{sorted(d)}")
        key, body = next(iter(d.items()))
        p = f"{path}.{key}"
        if key not in _REL_KEYS:
            raise SubstraitError(
                f"{path}: unknown relation type {key!r}; this consumer "
                f"understands {list(_REL_KEYS)}")
        if key == "read":
            cols = body.get("columns")
            return ReadRel(self._field(body, "table", p),
                           list(cols) if cols is not None else None,
                           self._opt_expr(body.get("filter"), p + ".filter"))
        if key == "filter":
            return FilterRel(
                self.rel(self._field(body, "input", p), p + ".input"),
                self.expr(self._field(body, "condition", p), p + ".condition"))
        if key == "project":
            exprs = [(self._field(x, "name", f"{p}.expressions[{i}]"),
                      self.expr(self._field(x, "expr", f"{p}.expressions[{i}]"),
                                f"{p}.expressions[{i}]"))
                     for i, x in enumerate(self._field(body, "expressions", p))]
            return ProjectRel(
                self.rel(self._field(body, "input", p), p + ".input"),
                exprs, bool(body.get("keepInput", False)))
        if key == "join":
            jt = self._field(body, "type", p)
            if jt not in _JOIN_TYPES_BACK:
                raise SubstraitError(
                    f"{p}: unknown join type {jt!r}; expected one of "
                    f"{sorted(_JOIN_TYPES_BACK)}")
            return JoinRel(
                probe=self.rel(self._field(body, "probe", p), p + ".probe"),
                build=self.rel(self._field(body, "build", p), p + ".build"),
                probe_keys=list(self._field(body, "probeKeys", p)),
                build_keys=list(self._field(body, "buildKeys", p)),
                how=_JOIN_TYPES_BACK[jt],
                mark_name=body.get("markName", "__mark"),
                post_filter=self._opt_expr(body.get("postFilter"),
                                           p + ".postFilter"))
        if key == "aggregate":
            aggs = []
            for i, m in enumerate(self._field(body, "measures", p)):
                mp = f"{p}.measures[{i}]"
                fn = self._function(m, mp)
                if FUNCTIONS.get(fn) != "aggregate":
                    raise SubstraitError(
                        f"{mp}: {fn!r} is not an aggregate function")
                aggs.append(AggSpec(
                    fn, self._opt_expr(m.get("argument"), mp),
                    self._field(m, "name", mp)))
            return AggregateRel(
                self.rel(self._field(body, "input", p), p + ".input"),
                list(self._field(body, "groupings", p)), aggs,
                self._opt_expr(body.get("having"), p + ".having"))
        if key == "sort":
            return SortRel(
                self.rel(self._field(body, "input", p), p + ".input"),
                self._sorts(self._field(body, "sorts", p), p + ".sorts"),
                body.get("limit"))
        if key == "fetch":
            return FetchRel(
                self.rel(self._field(body, "input", p), p + ".input"),
                int(self._field(body, "count", p)))
        if key == "exchange":
            return ExchangeRel(
                self.rel(self._field(body, "input", p), p + ".input"),
                self._field(body, "kind", p),
                list(body.get("keys", [])))
        if key == "set":
            inputs = self._field(body, "inputs", p)
            if not inputs:
                raise SubstraitError(
                    f"{p}: set relation requires at least one input")
            return SetRel(
                [self.rel(x, f"{p}.inputs[{i}]") for i, x in
                 enumerate(inputs)],
                body.get("op", "union_all"))
        if key == "window":
            fn = self._function(body, p)
            if FUNCTIONS.get(fn) not in ("window", "aggregate") \
                    or fn in ("count_star", "count_distinct"):
                raise SubstraitError(
                    f"{p}: {fn!r} is not a window function")
            if fn in ("sum", "avg", "min", "max") \
                    and body.get("argument") is None:
                raise SubstraitError(
                    f"{p}: window aggregate {fn!r} requires an 'argument' "
                    f"column")
            return WindowRel(
                input=self.rel(self._field(body, "input", p), p + ".input"),
                partition_keys=list(self._field(body, "partitionKeys", p)),
                order_keys=self._sorts(body.get("orderKeys", []),
                                       p + ".orderKeys"),
                func=fn,
                arg=body.get("argument"),
                name=body.get("name", "__window"))
        raise AssertionError(key)  # unreachable: key checked above


def _parse_extensions(wire: Dict[str, Any]) -> Dict[int, str]:
    uri_entries = wire.get("extensionUris", [])
    ext_entries = wire.get("extensions", [])
    if not isinstance(uri_entries, list) or not all(
            isinstance(u, dict) for u in uri_entries):
        raise SubstraitError("extensionUris must be a list of objects")
    if not isinstance(ext_entries, list):
        raise SubstraitError("extensions must be a list")
    uris = {u.get("extensionUriAnchor"): u.get("uri") for u in uri_entries}
    known_uris = set(EXTENSION_URIS.values())
    functions: Dict[int, str] = {}
    for i, ext in enumerate(ext_entries):
        body = ext.get("extensionFunction") if isinstance(ext, dict) else None
        if not isinstance(body, dict):
            raise SubstraitError(
                f"extensions[{i}]: expected an extensionFunction entry")
        name = body.get("name")
        uri_ref = body.get("extensionUriReference")
        anchor = body.get("functionAnchor")
        if uri_ref not in uris:
            raise SubstraitError(
                f"extensions[{i}]: extensionUriReference {uri_ref!r} is not "
                f"declared in extensionUris")
        if name not in FUNCTIONS:
            raise SubstraitError(
                f"extensions[{i}]: function {name!r} is not in this "
                f"consumer's registry (uri {uris[uri_ref]!r}); known "
                f"functions: {sorted(FUNCTIONS)}")
        if uris[uri_ref] not in known_uris:
            raise SubstraitError(
                f"extensions[{i}]: unknown extension uri {uris[uri_ref]!r} "
                f"for function {name!r}; this consumer serves "
                f"{sorted(known_uris)}")
        if not isinstance(anchor, int):
            raise SubstraitError(
                f"extensions[{i}]: functionAnchor must be an int, got "
                f"{anchor!r}")
        functions[anchor] = name
    return functions


def ingest(wire) -> Rel:
    """Deserialize a wire plan (dict, or its JSON text/bytes) into plan IR.

    Raises ``SubstraitError`` on any structural violation — version
    mismatch, unknown rel/function, dangling reference, missing field —
    with a path into the document.
    """
    if isinstance(wire, (bytes, bytearray)):
        wire = wire.decode("utf-8")
    if isinstance(wire, str):
        try:
            wire = json.loads(wire)
        except json.JSONDecodeError as e:
            raise SubstraitError(f"wire plan is not valid JSON: {e}") from e
    if not isinstance(wire, dict):
        raise SubstraitError(
            f"wire plan must be a JSON object, got {type(wire).__name__}")

    version = wire.get("version")
    if not isinstance(version, dict) or "majorNumber" not in version:
        raise SubstraitError("wire plan carries no version block")
    if version["majorNumber"] != WIRE_MAJOR:
        raise SubstraitError(
            f"wire major version {version['majorNumber']!r} is incompatible "
            f"with this consumer (expected {WIRE_MAJOR})")

    relations = wire.get("relations")
    if not isinstance(relations, list) or len(relations) != 1 \
            or not isinstance(relations[0], dict):
        raise SubstraitError("wire plan must carry exactly one relation tree")
    root = relations[0].get("root")
    if not isinstance(root, dict) or "input" not in root:
        raise SubstraitError("relations[0] must be {'root': {'input': ...}}")

    functions = _parse_extensions(wire)
    return _Ingester(functions).rel(root["input"], "relations[0].root.input")
