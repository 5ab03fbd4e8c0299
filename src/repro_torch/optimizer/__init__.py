"""Rule-based plan optimizer (the DuckDB-side rewrites of the paper) —
counterpart of ``repro/optimizer/__init__.py``.

The SQL frontend lowers to a deliberately naive plan; these passes rewrite
it into the shape the hand-built TPC-H plans are already in — filters at
the scans, narrow reads, selective joins first, smaller hash-build sides —
before the engine ever sees it.

``DEFAULT_RULES``, in application order:

  1. ``fold_constants``      — literal arithmetic/boolean folding.
  2. ``pushdown_predicates`` — FilterRel conjuncts sink through projections
     (rewriting through pure renames) and joins into ``ReadRel.filter``;
     conjuncts spanning both join sides become the join's ``post_filter``.
  3. ``prune_projections``   — required-column analysis top-down, landing
     in ``ReadRel.columns``.
  4. ``reorder_joins``       — greedy smallest-estimated-build-first
     ordering of left-deep inner/semi/anti chains under key-availability
     constraints.
  5. ``choose_build_sides``  — the smaller estimated side of an inner join
     becomes the hash-build side (the pipeline breaker, paper §3.2.2).
  6. ``order_conjuncts``     — most-selective-first AND ordering.

Cardinality model (``stats``): Selinger-style constants and FK-join
heuristics, upgraded with **dictionary-informed string selectivity** when
the catalog carries column dictionaries (``Catalog.with_dictionaries`` —
``SiriusEngine.sql`` attaches them automatically): LIKE / IN / prefix /
equality predicates are costed by their measured hit rate over the
dictionary, with the constants (``SEL_LIKE`` = 0.1, …) as fallback.

``optimize`` is pure — the input plan is never mutated — so naive/optimized
comparisons stay valid.  Pass a custom
``rules`` list (same ``(name, fn)`` shape) to ablate individual passes.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

from ..core.plan import Rel
from .rules import (
    choose_build_sides, fold_constants, order_conjuncts, prune_projections,
    pushdown_predicates, reorder_joins,
)
from .stats import annotate, estimate, rel_columns, selectivity

__all__ = [
    "DEFAULT_RULES", "annotate", "estimate", "optimize", "rel_columns",
    "selectivity",
]

# (name, pass) in application order; every pass is Rel × catalog → Rel
DEFAULT_RULES: List[Tuple[str, Callable[[Rel, object], Rel]]] = [
    ("fold_constants", fold_constants),
    ("pushdown_predicates", pushdown_predicates),
    ("prune_projections", prune_projections),
    ("reorder_joins", reorder_joins),
    ("choose_build_sides", choose_build_sides),
    ("order_conjuncts", order_conjuncts),
]


def optimize(plan: Rel, catalog=None, rules=None) -> Rel:
    """Apply the rule pipeline; annotate the result with row estimates.

    Args:
        plan: root of the (naive) plan IR — never mutated.
        catalog: schemas / row estimates / optional dictionaries driving
            the cost heuristics (default: the TPC-H catalog).
        rules: override ``DEFAULT_RULES`` — a list of ``(name, fn)`` pairs
            applied in order; use to ablate or extend passes.

    Returns:
        A rewritten plan with ``estimated_rows`` stamped on every node
        (shown by ``explain``).
    """
    if catalog is None:
        from ..sql.binder import DEFAULT_CATALOG
        catalog = DEFAULT_CATALOG
    for _name, rule in (DEFAULT_RULES if rules is None else rules):
        plan = rule(plan, catalog)
    return annotate(plan, catalog)
