"""Recursive-descent SQL parser — counterpart of ``repro/sql/parser.py``.

Grammar (the TPC-H-sufficient subset demanded by the paper's drop-in claim):

  select    := SELECT [DISTINCT] items FROM tables [WHERE expr]
               [GROUP BY expr_list] [HAVING expr]
               [ORDER BY order_list] [LIMIT n]
  items     := '*' | item (',' item)*          item := expr [[AS] ident]
  tables    := table (',' table | [INNER|LEFT [OUTER]] JOIN table ON expr)*
  expr      := or_expr                          (precedence climbing below)

Expression precedence (loosest first): OR, AND, NOT, predicates
(comparison / BETWEEN / IN / LIKE / IS), additive, multiplicative, unary.
"""
from __future__ import annotations

from typing import List

from ..relational.expressions import (
    Between, BinOp, Case, Cast, DateLit, Expr, ExtractYear, InList, Like, Lit,
    StartsWith, Substr, UnOp,
)
from .lexer import EOF, IDENT, NUM, STR, SqlError, Token, tokenize
from .nodes import (
    AGG_FUNCS, IntervalLit, OrderItem, SelectItem, SelectStmt, SqlCol,
    SqlExists, SqlFunc, SqlInSubquery, SqlSubquery, Star, TableRef,
)

_CMP_OPS = ("=", "<>", "!=", "<", "<=", ">", ">=")
_CAST_TYPES = {
    "double": "float64", "float": "float32", "real": "float32",
    "int": "int64", "integer": "int64", "bigint": "int64",
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -- token plumbing ----------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.cur
        self.i += 1
        return t

    def accept_kw(self, *names: str) -> bool:
        if self.cur.is_kw(*names):
            self.i += 1
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.cur.is_op(*ops):
            self.i += 1
            return True
        return False

    def expect_kw(self, name: str) -> None:
        if not self.accept_kw(name):
            self.error(f"expected {name.upper()}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            self.error(f"expected {op!r}")

    def expect_ident(self) -> str:
        if self.cur.kind != IDENT:
            self.error("expected identifier")
        return self.advance().value

    def error(self, msg: str):
        got = self.cur.value if self.cur.kind != EOF else "<end of input>"
        raise SqlError(f"{msg}, got {got!r}", self.sql, self.cur.pos)

    # -- statement ---------------------------------------------------------
    def parse(self) -> SelectStmt:
        stmt = self.parse_select()
        self.accept_op(";")
        if self.cur.kind != EOF:
            self.error("trailing input after statement")
        return stmt

    def parse_select(self) -> SelectStmt:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        items = self.parse_items()
        self.expect_kw("from")
        tables, join_conds, left_joins = self.parse_tables()
        where = self.parse_expr() if self.accept_kw("where") else None
        for cond in join_conds:       # JOIN ... ON conditions fold into WHERE
            where = cond if where is None else BinOp("and", where, cond)
        group_by: List[Expr] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())
        having = self.parse_expr() if self.accept_kw("having") else None
        order_by: List[OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        limit = None
        if self.accept_kw("limit"):
            if self.cur.kind != NUM or not isinstance(self.cur.value, int):
                self.error("LIMIT expects an integer")
            limit = self.advance().value
        return SelectStmt(items, tables, where, group_by, having, order_by,
                          limit, distinct, left_joins)

    def parse_items(self) -> List[SelectItem]:
        if self.accept_op("*"):
            return [SelectItem(Star())]
        items = [self.parse_item()]
        while self.accept_op(","):
            items.append(self.parse_item())
        return items

    def parse_item(self) -> SelectItem:
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.cur.kind == IDENT:
            alias = self.advance().value
        return SelectItem(e, alias)

    def parse_tables(self):
        """→ (tables, inner-join ON conds, [(left-join table, ON cond)])."""
        tables = [self.parse_table_ref()]
        join_conds: List[Expr] = []
        left_joins = []
        while True:
            if self.accept_op(","):
                tables.append(self.parse_table_ref())
                continue
            if self.cur.is_kw("join", "inner", "left"):
                if self.accept_kw("left"):
                    self.accept_kw("outer")
                    self.expect_kw("join")
                    t = self.parse_table_ref()
                    self.expect_kw("on")
                    left_joins.append((t, self.parse_expr()))
                    continue
                self.accept_kw("inner")
                self.expect_kw("join")
                tables.append(self.parse_table_ref())
                self.expect_kw("on")
                join_conds.append(self.parse_expr())
                continue
            return tables, join_conds, left_joins

    def parse_table_ref(self) -> TableRef:
        if self.cur.is_op("("):
            self.advance()
            if not self.cur.is_kw("select"):
                self.error("expected SELECT in derived table")
            sub = self.parse_select()
            self.expect_op(")")
            self.accept_kw("as")
            if self.cur.kind != IDENT:
                self.error("derived table requires an alias")
            alias = self.advance().value
            return TableRef(alias, alias, subquery=sub)
        name = self.expect_ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.cur.kind == IDENT:
            alias = self.advance().value
        return TableRef(name, alias)

    def parse_order_item(self) -> OrderItem:
        e = self.parse_expr()
        asc = True
        if self.accept_kw("desc"):
            asc = False
        else:
            self.accept_kw("asc")
        return OrderItem(e, asc)

    # -- expressions -------------------------------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        e = self.parse_and()
        while self.accept_kw("or"):
            e = BinOp("or", e, self.parse_and())
        return e

    def parse_and(self) -> Expr:
        e = self.parse_not()
        while self.accept_kw("and"):
            e = BinOp("and", e, self.parse_not())
        return e

    def parse_not(self) -> Expr:
        if self.accept_kw("not"):
            inner = self.parse_not()
            if isinstance(inner, SqlExists):
                inner.negate = not inner.negate
                return inner
            return UnOp("not", inner)
        return self.parse_predicate()

    def parse_predicate(self) -> Expr:
        e = self.parse_additive()
        negate = False
        if self.cur.is_kw("not"):
            nxt = self.toks[self.i + 1]
            if nxt.is_kw("between", "in", "like"):
                self.advance()
                negate = True
        if self.accept_kw("between"):
            lo = self.parse_additive()
            self.expect_kw("and")
            hi = self.parse_additive()
            out: Expr = Between(e, lo, hi)
            return UnOp("not", out) if negate else out
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.cur.is_kw("select"):
                sub = self.parse_select()
                self.expect_op(")")
                return SqlInSubquery(e, sub, negate)
            values = [self.parse_literal_value()]
            while self.accept_op(","):
                values.append(self.parse_literal_value())
            self.expect_op(")")
            return InList(e, values, negate)
        if self.accept_kw("like"):
            if self.cur.kind != STR:
                self.error("LIKE expects a string literal pattern")
            return Like(e, self.advance().value, negate)
        if negate:
            self.error("expected BETWEEN / IN / LIKE after NOT")
        if self.accept_kw("is"):
            neg = self.accept_kw("not")
            self.expect_kw("null")
            # engine has no NULLs: IS NULL is constant false, IS NOT NULL true
            return Lit(bool(neg))
        for op in _CMP_OPS:
            if self.accept_op(op):
                rhs = self.parse_additive()
                canon = {"=": "==", "<>": "!="}.get(op, op)
                return BinOp(canon, e, rhs)
        return e

    def parse_literal_value(self):
        neg = self.accept_op("-")
        t = self.cur
        if t.kind == NUM:
            self.advance()
            return -t.value if neg else t.value
        if t.kind == STR and not neg:
            self.advance()
            return t.value
        self.error("expected literal in IN list")

    def parse_additive(self) -> Expr:
        e = self.parse_multiplicative()
        while True:
            if self.accept_op("+"):
                e = BinOp("+", e, self.parse_multiplicative())
            elif self.accept_op("-"):
                e = BinOp("-", e, self.parse_multiplicative())
            else:
                return e

    def parse_multiplicative(self) -> Expr:
        e = self.parse_unary()
        while True:
            if self.accept_op("*"):
                e = BinOp("*", e, self.parse_unary())
            elif self.accept_op("/"):
                e = BinOp("/", e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> Expr:
        if self.accept_op("-"):
            inner = self.parse_unary()
            if isinstance(inner, Lit) and inner.kind is None:
                return Lit(-inner.value)
            return UnOp("-", inner)
        self.accept_op("+")
        return self.parse_primary()

    # -- primaries ---------------------------------------------------------
    def parse_primary(self) -> Expr:
        t = self.cur
        if t.kind == NUM:
            self.advance()
            return Lit(t.value)
        if t.kind == STR:
            self.advance()
            return Lit(t.value)
        if t.is_kw("true"):
            self.advance()
            return Lit(True)
        if t.is_kw("false"):
            self.advance()
            return Lit(False)
        if t.is_kw("date"):
            self.advance()
            if self.cur.kind != STR:
                self.error("DATE expects a 'yyyy-mm-dd' string")
            return DateLit(self.advance().value)
        if t.is_kw("interval"):
            self.advance()
            if self.cur.kind != STR:
                self.error("INTERVAL expects a quoted amount")
            amount = int(self.advance().value)
            if not self.cur.is_kw("year", "month", "day"):
                self.error("INTERVAL unit must be YEAR, MONTH or DAY")
            return IntervalLit(amount, self.advance().value)
        if t.is_kw("case"):
            return self.parse_case()
        if t.is_kw("exists"):
            self.advance()
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return SqlExists(sub)
        if t.is_kw("extract"):
            self.advance()
            self.expect_op("(")
            if not self.accept_kw("year"):
                self.error("only EXTRACT(YEAR FROM ...) is supported")
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_op(")")
            return ExtractYear(e)
        if t.is_kw("substring"):
            self.advance()
            self.expect_op("(")
            e = self.parse_expr()
            if self.accept_kw("from"):
                start = self.parse_int("SUBSTRING start")
                self.expect_kw("for")
                length = self.parse_int("SUBSTRING length")
            else:
                self.expect_op(",")
                start = self.parse_int("SUBSTRING start")
                self.expect_op(",")
                length = self.parse_int("SUBSTRING length")
            self.expect_op(")")
            return Substr(e, start, length)
        if t.is_kw("cast"):
            self.advance()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            tyname = self.expect_ident() if self.cur.kind == IDENT else None
            if tyname not in _CAST_TYPES:
                self.error(f"unsupported CAST target {tyname!r}")
            self.expect_op(")")
            return Cast(e, _CAST_TYPES[tyname])
        if t.is_op("("):
            self.advance()
            if self.cur.is_kw("select"):
                sub = self.parse_select()
                self.expect_op(")")
                return SqlSubquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == IDENT:
            name = self.advance().value
            if self.cur.is_op("("):                      # function call
                return self.parse_func(name)
            if self.accept_op("."):
                col = self.expect_ident()
                return SqlCol(name, col)
            return SqlCol(None, name)
        self.error("expected expression")

    def parse_int(self, what: str) -> int:
        if self.cur.kind != NUM or not isinstance(self.cur.value, int):
            self.error(f"{what} must be an integer literal")
        return self.advance().value

    def parse_func(self, name: str) -> Expr:
        if name == "starts_with":
            # starts_with(string_expr, 'prefix'): prefix predicate — lowers
            # to a contiguous code-range compare on the sorted dictionary
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_op(",")
            if self.cur.kind != STR:
                self.error("starts_with expects a string literal prefix")
            prefix = self.advance().value
            self.expect_op(")")
            return StartsWith(e, prefix)
        if name == "substr":
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_op(",")
            start = self.parse_int("substr start")
            self.expect_op(",")
            length = self.parse_int("substr length")
            self.expect_op(")")
            return Substr(e, start, length)
        if name not in AGG_FUNCS:
            self.error(f"unknown function {name!r}")
        self.expect_op("(")
        if name == "count" and self.accept_op("*"):
            self.expect_op(")")
            return SqlFunc("count", None)
        distinct = self.accept_kw("distinct")
        arg = self.parse_expr()
        self.expect_op(")")
        return SqlFunc(name, arg, distinct)

    def parse_case(self) -> Expr:
        self.expect_kw("case")
        whens = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            whens.append((cond, self.parse_expr()))
        if not whens:
            self.error("CASE requires at least one WHEN")
        default: Expr = Lit(0)
        if self.accept_kw("else"):
            default = self.parse_expr()
        self.expect_kw("end")
        return Case(whens, default)


def parse_sql(sql: str) -> SelectStmt:
    return Parser(sql).parse()
