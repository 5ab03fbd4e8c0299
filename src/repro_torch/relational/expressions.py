"""Expression IR + vectorized evaluator — counterpart of ``repro/relational/expressions.py``.

Expressions are evaluated column-at-a-time on the table's device.  String
predicates (LIKE, substring, prefix) are evaluated once against the
host-side *dictionary* and then become a gather or compare by code.

Promotion follows the reference (JAX with x64 on): an int literal is a
*weakly typed* int64 — in a binary operation it takes the other side's dtype
(``int32 days + 5`` stays int32) — while a float literal is a strong float64
that lifts the other side to float64 (``float32 * 2.0`` is float64).
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import strings
from .table import BOOL, DATE, NUMERIC, STRING, Column, Table, date_to_days


class Expr:
    """Base class for expression nodes."""

    # operator sugar ------------------------------------------------------
    def __add__(self, o): return BinOp("+", self, _wrap(o))
    def __radd__(self, o): return BinOp("+", _wrap(o), self)
    def __sub__(self, o): return BinOp("-", self, _wrap(o))
    def __rsub__(self, o): return BinOp("-", _wrap(o), self)
    def __mul__(self, o): return BinOp("*", self, _wrap(o))
    def __rmul__(self, o): return BinOp("*", _wrap(o), self)
    def __truediv__(self, o): return BinOp("/", self, _wrap(o))
    def __eq__(self, o): return BinOp("==", self, _wrap(o))  # type: ignore[override]
    def __ne__(self, o): return BinOp("!=", self, _wrap(o))  # type: ignore[override]
    def __lt__(self, o): return BinOp("<", self, _wrap(o))
    def __le__(self, o): return BinOp("<=", self, _wrap(o))
    def __gt__(self, o): return BinOp(">", self, _wrap(o))
    def __ge__(self, o): return BinOp(">=", self, _wrap(o))
    def __and__(self, o): return BinOp("and", self, _wrap(o))
    def __or__(self, o): return BinOp("or", self, _wrap(o))
    def __invert__(self): return UnOp("not", self)
    def __hash__(self):  # needed because __eq__ is overloaded
        return id(self)

    def equals(self, other) -> bool:
        """Structural equality — the safe idiom for comparing expressions.

        ``==`` is overloaded to *build* a BinOp node, so ``in``,
        ``list.remove`` and ``.index`` silently misbehave on Expr lists.
        """
        return expr_equal(self, other)

    same = equals

    def columns(self) -> List[str]:
        """Free column references (for projection pruning)."""
        out: List[str] = []
        _collect_columns(self, out)
        return out


def _wrap(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    return Lit(v)


@dataclasses.dataclass(eq=False)
class Col(Expr):
    name: str


@dataclasses.dataclass(eq=False)
class Lit(Expr):
    value: Any
    kind: Optional[str] = None  # force interpretation, e.g. DATE

    def resolved_kind(self) -> str:
        if self.kind:
            return self.kind
        if isinstance(self.value, str):
            return STRING
        if isinstance(self.value, bool):
            return BOOL
        return NUMERIC


def DateLit(s: str) -> Lit:
    return Lit(date_to_days(s), DATE)


@dataclasses.dataclass(eq=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr


@dataclasses.dataclass(eq=False)
class UnOp(Expr):
    op: str
    operand: Expr


@dataclasses.dataclass(eq=False)
class Between(Expr):
    operand: Expr
    lo: Expr
    hi: Expr


@dataclasses.dataclass(eq=False)
class InList(Expr):
    operand: Expr
    values: Sequence[Any]
    negate: bool = False


@dataclasses.dataclass(eq=False)
class Like(Expr):
    """SQL LIKE: ``%`` any run, ``_`` any char, backslash escapes both."""
    operand: Expr
    pattern: str
    negate: bool = False


@dataclasses.dataclass(eq=False)
class StartsWith(Expr):
    """Prefix predicate: a contiguous code range on a sorted dictionary."""
    operand: Expr
    prefix: str
    negate: bool = False


@dataclasses.dataclass(eq=False)
class Case(Expr):
    whens: Sequence[Tuple[Expr, Expr]]
    default: Expr


@dataclasses.dataclass(eq=False)
class ExtractYear(Expr):
    operand: Expr


@dataclasses.dataclass(eq=False)
class Substr(Expr):
    """SQL substring(col, start, length) — 1-based, host dictionary rewrite."""
    operand: Expr
    start: int
    length: int


@dataclasses.dataclass(eq=False)
class Cast(Expr):
    operand: Expr
    dtype: str  # "float64" | "float32" | "int64" | "int32"


def _collect_columns(e: Expr, out: List[str]) -> None:
    if isinstance(e, Col):
        out.append(e.name)
    elif isinstance(e, BinOp):
        _collect_columns(e.left, out); _collect_columns(e.right, out)
    elif isinstance(e, UnOp):
        _collect_columns(e.operand, out)
    elif isinstance(e, Between):
        for x in (e.operand, e.lo, e.hi):
            _collect_columns(x, out)
    elif isinstance(e, (InList, Like, StartsWith, ExtractYear, Substr, Cast)):
        _collect_columns(e.operand, out)
    elif isinstance(e, Case):
        for c, v in e.whens:
            _collect_columns(c, out); _collect_columns(v, out)
        _collect_columns(e.default, out)


# ---------------------------------------------------------------------------
# generic structural helpers
# ---------------------------------------------------------------------------


def expr_children(e: Expr) -> List[Expr]:
    """Immediate Expr children, generic over the dataclass fields."""
    out: List[Expr] = []
    if not dataclasses.is_dataclass(e):
        return out
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, Expr):
                    out.append(item)
                elif isinstance(item, (list, tuple)):
                    out.extend(x for x in item if isinstance(x, Expr))
    return out


def walk_expr(e: Expr):
    """Pre-order traversal over an expression tree (does not enter sub-plans)."""
    yield e
    for c in expr_children(e):
        yield from walk_expr(c)


def transform_expr(e: Expr, fn) -> Expr:
    """Bottom-up rebuild: apply ``fn`` to every node, children first."""
    if not dataclasses.is_dataclass(e):
        return fn(e)
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            nv = transform_expr(v, fn)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, (list, tuple)):
            new_items, dirty = [], False
            for item in v:
                if isinstance(item, Expr):
                    ni = transform_expr(item, fn)
                    dirty |= ni is not item
                    new_items.append(ni)
                elif isinstance(item, tuple):
                    ni = tuple(transform_expr(x, fn) if isinstance(x, Expr)
                               else x for x in item)
                    dirty |= any(a is not b for a, b in zip(ni, item))
                    new_items.append(ni)
                else:
                    new_items.append(item)
            if dirty:
                changes[f.name] = type(v)(new_items) if isinstance(v, tuple) \
                    else new_items
    if changes:
        e = dataclasses.replace(e, **changes)
    return fn(e)


def expr_equal(a, b, rel_eq=None) -> bool:
    """Structural equality (Expr.__eq__ is overloaded to build BinOp).

    ``rel_eq`` compares embedded non-Expr dataclasses (plan sub-trees inside
    ScalarSubquery); defaults to identity.
    """
    if a is b:
        return True
    if isinstance(a, Expr) or isinstance(b, Expr):
        if type(a) is not type(b):
            return False
        for f in dataclasses.fields(a):
            if not expr_equal(getattr(a, f.name), getattr(b, f.name), rel_eq):
                return False
        return True
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            expr_equal(x, y, rel_eq) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a) or dataclasses.is_dataclass(b):
        if type(a) is not type(b):
            return False
        return rel_eq(a, b) if rel_eq is not None else a is b
    return a == b


def split_conjuncts(e: Optional[Expr]) -> List[Expr]:
    """Flatten an AND tree into its conjuncts (None → [])."""
    if e is None:
        return []
    if isinstance(e, BinOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def and_all(conjuncts: Sequence[Expr]) -> Optional[Expr]:
    """Rebuild an AND tree from conjuncts ([] → None)."""
    out: Optional[Expr] = None
    for c in conjuncts:
        out = c if out is None else BinOp("and", out, c)
    return out


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

# python operators, so a weak scalar may stand on either side
_ARITH = {"+": operator.add, "-": operator.sub, "*": operator.mul,
          "/": operator.truediv}
_CMP = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge}

def _string_lit_cmp(col: Column, op: str, lit: str) -> Column:
    """Compare a dict-encoded string column with a string literal.

    The dictionary is sorted, so codes are ranks: integer comparison against
    the literal's insertion point is exact lexicographic comparison.
    """
    d = col.dictionary
    left = int(np.searchsorted(d, lit, side="left"))
    present = left < len(d) and d[left] == lit
    codes = col.data
    if op == "==":
        return Column(codes == left if present else torch.zeros_like(codes, dtype=torch.bool), BOOL)
    if op == "!=":
        return Column(codes != left if present else torch.ones_like(codes, dtype=torch.bool), BOOL)
    if op == "<":
        return Column(codes < left, BOOL)
    if op == ">=":
        return Column(codes >= left, BOOL)
    if op == "<=":
        right = int(np.searchsorted(d, lit, side="right"))
        return Column(codes < right, BOOL)
    if op == ">":
        right = int(np.searchsorted(d, lit, side="right"))
        return Column(codes >= right, BOOL)
    raise ValueError(f"bad string comparison {op}")


def _lit_tensor(lit: Lit, n: int, device) -> torch.Tensor:
    val = lit.value
    if isinstance(val, bool):
        dt = torch.bool
    elif isinstance(val, float):
        dt = torch.float64
    else:
        dt = torch.int64
    return torch.full((n,), val, dtype=dt, device=device)


def _lit_operand(lit: Lit, other: torch.Tensor):
    """A literal meeting a tensor in a binary op, typed as the reference types it.

    An int literal stays a python int, which under torch's promotion takes
    the tensor's dtype as a weak literal does under JAX's.  A float literal
    is a strong float64 in the reference, so the tensor is lifted to
    float64."""
    val = lit.value
    if isinstance(val, float) and other.dtype != torch.float64:
        other = other.to(torch.float64)
    return val, other


def _binop_data(expr: BinOp, table: Table):
    """→ (left kind, right kind, left operand, right operand) of a numeric
    binary op, with the reference's promotion (see the module docstring)."""
    le, re_ = expr.left, expr.right
    l_lit = isinstance(le, Lit) and le.resolved_kind() != STRING
    r_lit = isinstance(re_, Lit) and re_.resolved_kind() != STRING
    if l_lit and not r_lit:
        r = evaluate(re_, table)
        lv, rd = _lit_operand(le, r.data)
        return le.resolved_kind(), r.kind, lv, rd
    if r_lit and not l_lit:
        l = evaluate(le, table)
        rv, ld = _lit_operand(re_, l.data)
        return l.kind, re_.resolved_kind(), ld, rv
    l = evaluate(le, table)
    r = evaluate(re_, table)
    if l.kind == STRING and r.kind == STRING:
        # column-vs-column string compare: unify dictionaries first
        from .table import unify_string_keys
        l, r = unify_string_keys(l, r)
    return l.kind, r.kind, l.data, r.data


def evaluate(expr: Expr, table: Table) -> Column:
    """Evaluate ``expr`` against ``table`` → Column (tensor on the table's device)."""
    if isinstance(expr, Col):
        return table[expr.name]

    if isinstance(expr, Lit):
        k = expr.resolved_kind()
        if k == STRING:
            raise ValueError("bare string literal column not supported; use comparisons")
        return Column(_lit_tensor(expr, table.num_rows, table.device), k)

    if isinstance(expr, BinOp):
        if expr.op in ("and", "or"):
            l = evaluate(expr.left, table).data
            r = evaluate(expr.right, table).data
            fn = torch.logical_and if expr.op == "and" else torch.logical_or
            return Column(fn(l, r), BOOL)

        # string vs literal comparisons take the dictionary path
        if expr.op in _CMP:
            le, re_ = expr.left, expr.right
            if isinstance(re_, Lit) and re_.resolved_kind() == STRING:
                lc = evaluate(le, table)
                if lc.kind == STRING:
                    return _string_lit_cmp(lc, expr.op, re_.value)
            if isinstance(le, Lit) and le.resolved_kind() == STRING:
                rc = evaluate(re_, table)
                if rc.kind == STRING:
                    return _string_lit_cmp(rc, _flip(expr.op), le.value)

        lk, rk, ld, rd = _binop_data(expr, table)
        if expr.op in _CMP:
            return Column(_CMP[expr.op](ld, rd), BOOL)
        if expr.op in _ARITH:
            if expr.op == "/":
                if isinstance(ld, torch.Tensor):
                    ld = ld.to(torch.float64)
                else:  # literal numerator: the result is float64 either way
                    rd = rd.to(torch.float64)
            out_kind = DATE if (lk == DATE or rk == DATE) and expr.op in ("+", "-") else NUMERIC
            if lk == DATE and rk == DATE:
                out_kind = NUMERIC  # date difference = days
            return Column(_ARITH[expr.op](ld, rd), out_kind)
        raise ValueError(f"unknown binop {expr.op}")

    if isinstance(expr, UnOp):
        v = evaluate(expr.operand, table)
        if expr.op == "not":
            return Column(torch.logical_not(v.data), BOOL)
        if expr.op == "-":
            return Column(torch.neg(v.data), v.kind)
        raise ValueError(f"unknown unop {expr.op}")

    if isinstance(expr, Between):
        v = evaluate(expr.operand, table).data
        lo = expr.lo.value if isinstance(expr.lo, Lit) else evaluate(expr.lo, table).data
        hi = expr.hi.value if isinstance(expr.hi, Lit) else evaluate(expr.hi, table).data
        return Column((v >= lo) & (v <= hi), BOOL)

    if isinstance(expr, InList):
        v = evaluate(expr.operand, table)
        if v.kind == STRING:
            # one-time host pass over the dictionary → cached device code mask
            hit = strings.in_list_mask(v.dictionary, [str(x) for x in expr.values],
                                       v.data.device)[v.data.long()]
        else:
            hit = torch.zeros(v.data.shape, dtype=torch.bool, device=v.data.device)
            for val in expr.values:
                hit = hit | (v.data == val)
        if expr.negate:
            hit = torch.logical_not(hit)
        return Column(hit, BOOL)

    if isinstance(expr, Like):
        v = evaluate(expr.operand, table)
        if v.kind != STRING:
            raise ValueError("LIKE on non-string column")
        kind, lit = strings.analyze_like(expr.pattern)
        if kind == "prefix":
            hit = _prefix_hit(v, lit)
        elif kind == "exact":
            code = strings.exact_code(v.dictionary, lit)
            hit = (v.data == code) if code is not None \
                else torch.zeros(v.data.shape, dtype=torch.bool, device=v.data.device)
        else:
            hit = strings.like_mask(v.dictionary, expr.pattern,
                                    v.data.device)[v.data.long()]
        if expr.negate:
            hit = torch.logical_not(hit)
        return Column(hit, BOOL)

    if isinstance(expr, StartsWith):
        v = evaluate(expr.operand, table)
        if v.kind != STRING:
            raise ValueError("starts_with on non-string column")
        hit = _prefix_hit(v, expr.prefix)
        if expr.negate:
            hit = torch.logical_not(hit)
        return Column(hit, BOOL)

    if isinstance(expr, Case):
        default = evaluate(expr.default, table)
        out = default.data
        kind = default.kind
        for cond, val in reversed(list(expr.whens)):
            c = evaluate(cond, table).data
            vv = evaluate(val, table)
            out = torch.where(c, vv.data, out)
            kind = vv.kind
        return Column(out, kind)

    if isinstance(expr, ExtractYear):
        v = evaluate(expr.operand, table)
        if v.kind != DATE:
            raise ValueError("extract(year) on non-date")
        return Column(_year_from_days(v.data), NUMERIC)

    if isinstance(expr, Substr):
        v = evaluate(expr.operand, table)
        if v.kind != STRING:
            raise ValueError("substr on non-string")
        new_dict, remap = strings.substr_transform(
            v.dictionary, expr.start, expr.length, v.data.device)
        return Column(remap[v.data.long()], STRING, new_dict)

    if isinstance(expr, Cast):
        v = evaluate(expr.operand, table)
        return Column(v.data.to(getattr(torch, expr.dtype)), NUMERIC)

    raise TypeError(f"cannot evaluate {type(expr)}")


def _prefix_hit(col: Column, prefix: str) -> torch.Tensor:
    """Prefix predicate over a dictionary-encoded column: codes are ranks of
    a sorted dictionary, so the matching codes form [lo, hi)."""
    lo, hi = strings.prefix_range(col.dictionary, prefix)
    if lo >= hi:
        return torch.zeros(col.data.shape, dtype=torch.bool, device=col.data.device)
    return (col.data >= lo) & (col.data < hi)


def _flip(op: str) -> str:
    return {"==": "==", "!=": "!=", "<": ">", ">": "<", "<=": ">=", ">=": "<="}[op]


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _year_from_days(days: torch.Tensor) -> torch.Tensor:
    """Civil year from days since 1970-01-01 (Howard Hinnant's algorithm).

    Every division floors, as ``//`` does in the reference."""
    z = days.to(torch.int32) + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y).to(torch.int32)


__all__ = [
    "Between", "BinOp", "Case", "Cast", "Col", "DateLit", "Expr", "ExtractYear",
    "InList", "Like", "Lit", "StartsWith", "Substr", "UnOp", "and_all",
    "evaluate", "expr_children", "expr_equal", "split_conjuncts",
    "transform_expr", "walk_expr",
]
