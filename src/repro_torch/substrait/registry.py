"""Function + capability registries for the plan-interchange boundary —
counterpart of ``repro/substrait/registry.py``.

Two registries live here:

* the **function registry** — every scalar/aggregate/window operation the
  wire format can express, grouped under Substrait-style extension YAML
  URIs.  ``emit`` declares the functions a plan uses in the wire's
  ``extensions`` block (anchor → name) and ``ingest`` refuses anchors or
  names it does not know with an actionable ``SubstraitError``, exactly how
  Substrait consumers negotiate capability with producers.

* the **capability registry** — the per-rel / per-expr table the hybrid
  router consults to decide which plan fragments the device engine can own
  and which must degrade to the host fallback (``core.fallback``).  This is
  Sirius's drop-in contract: an unsupported rel (WindowRel, SetRel — or
  anything a test marks host-only) costs a fragment boundary, never an
  error.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Optional

from ..core.plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, Rel, ScalarSubquery, SetRel, SortRel, WindowRel, rel_exprs,
)
from ..relational.expressions import (
    Between, BinOp, Case, Cast, Col, Expr, ExtractYear, InList, Like, Lit,
    StartsWith, Substr, UnOp, walk_expr,
)

# ---------------------------------------------------------------------------
# function registry (wire vocabulary)
# ---------------------------------------------------------------------------

_EXT_BASE = "https://github.com/substrait-io/substrait/blob/main/extensions/"

EXTENSION_URIS: Dict[str, str] = {
    "arithmetic": _EXT_BASE + "functions_arithmetic.yaml",
    "comparison": _EXT_BASE + "functions_comparison.yaml",
    "boolean": _EXT_BASE + "functions_boolean.yaml",
    "string": _EXT_BASE + "functions_string.yaml",
    "datetime": _EXT_BASE + "functions_datetime.yaml",
    "type": _EXT_BASE + "functions_type.yaml",
    "aggregate": _EXT_BASE + "functions_aggregate_generic.yaml",
    "window": _EXT_BASE + "functions_window.yaml",
}

# function name -> extension group.  Scalar functions carry the whole Expr
# vocabulary; aggregate/window names serve AggregateRel measures + WindowRel.
FUNCTIONS: Dict[str, str] = {
    # BinOp arithmetic
    "add": "arithmetic", "subtract": "arithmetic", "multiply": "arithmetic",
    "divide": "arithmetic", "negate": "arithmetic",
    # BinOp comparisons + Between/InList
    "equal": "comparison", "not_equal": "comparison", "lt": "comparison",
    "lte": "comparison", "gt": "comparison", "gte": "comparison",
    "between": "comparison", "index_in": "comparison",
    # boolean connectives, UnOp not, Case
    "and": "boolean", "or": "boolean", "not": "boolean",
    "if_then": "boolean",
    # string predicates/transforms
    "like": "string", "starts_with": "string", "substring": "string",
    # datetime
    "extract_year": "datetime",
    # casts
    "cast": "type",
    # aggregate measures (AggSpec.fn names)
    "sum": "aggregate", "avg": "aggregate", "min": "aggregate",
    "max": "aggregate", "count": "aggregate", "count_star": "aggregate",
    "count_distinct": "aggregate",
    # window functions
    "row_number": "window", "rank": "window",
}

# BinOp.op <-> registry name
BINOP_TO_FUNCTION: Dict[str, str] = {
    "+": "add", "-": "subtract", "*": "multiply", "/": "divide",
    "==": "equal", "!=": "not_equal", "<": "lt", "<=": "lte",
    ">": "gt", ">=": "gte", "and": "and", "or": "or",
}
FUNCTION_TO_BINOP = {v: k for k, v in BINOP_TO_FUNCTION.items()}


def function_uri(name: str) -> str:
    return EXTENSION_URIS[FUNCTIONS[name]]


# ---------------------------------------------------------------------------
# capability registry (hybrid routing)
# ---------------------------------------------------------------------------

# Everything the push-based device executor can lower (core.executor
# PlanLowering + relational ops).  WindowRel / SetRel are deliberately
# absent: known to the wire, host-only at execution time.
DEVICE_RELS: FrozenSet[str] = frozenset(c.__name__ for c in (
    ReadRel, FilterRel, ProjectRel, JoinRel, AggregateRel, SortRel,
    FetchRel, ExchangeRel))

# Everything relational.expressions.evaluate handles on device.
DEVICE_EXPRS: FrozenSet[str] = frozenset(c.__name__ for c in (
    Col, Lit, BinOp, UnOp, Between, InList, Like, StartsWith, Case,
    ExtractYear, Substr, Cast, ScalarSubquery))

# The host fallback executes the full vocabulary.
HOST_RELS: FrozenSet[str] = DEVICE_RELS | frozenset(
    c.__name__ for c in (SetRel, WindowRel))


class CapabilityRegistry:
    """Per-rel / per-expr device-capability table.

    ``host_only_rels`` / ``host_only_exprs`` subtract capability (type
    names), which is how tests simulate an engine that lacks, say, LIKE —
    the router must respond by moving the containing rel to the host
    fragment, not by failing the query.
    """

    def __init__(self,
                 device_rels: Optional[Iterable[str]] = None,
                 device_exprs: Optional[Iterable[str]] = None,
                 host_only_rels: Iterable[str] = (),
                 host_only_exprs: Iterable[str] = ()):
        self.device_rels = frozenset(device_rels or DEVICE_RELS) \
            - frozenset(host_only_rels)
        self.device_exprs = frozenset(device_exprs or DEVICE_EXPRS) \
            - frozenset(host_only_exprs)

    # -- per-expr ----------------------------------------------------------
    def expr_on_device(self, e: Expr) -> bool:
        for node in walk_expr(e):
            if type(node).__name__ not in self.device_exprs:
                return False
            if isinstance(node, ScalarSubquery):
                # the executor resolves the sub-plan on device before the
                # pipeline runs, so its rels count against this expr
                if not self.plan_on_device(node.plan):
                    return False
        return True

    # -- per-rel -----------------------------------------------------------
    def rel_on_device(self, rel: Rel) -> bool:
        """Can the device engine own this node (exprs included, children
        excluded — fragment assembly is the router's job)?"""
        if type(rel).__name__ not in self.device_rels:
            return False
        return all(self.expr_on_device(e) for e in rel_exprs(rel))

    def plan_on_device(self, plan: Rel) -> bool:
        """Whole-subtree capability (used for scalar-subquery plans)."""
        return self.rel_on_device(plan) and all(
            self.plan_on_device(c) for c in plan.inputs())

    def placement(self, rel: Rel) -> str:
        return "device" if self.rel_on_device(rel) else "host"


DEFAULT_REGISTRY = CapabilityRegistry()
