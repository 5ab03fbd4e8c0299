"""SQL tokenizer — counterpart of ``repro/sql/lexer.py``.

Hand-rolled scanner producing a flat token stream for the recursive-descent
parser.  Keywords are case-insensitive; identifiers are lowercased (TPC-H
catalogs are all lower-case); string literals use single quotes with ''
escaping; numbers distinguish int/float.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


class SqlError(ValueError):
    """Parse/bind error with source position context."""

    def __init__(self, message: str, sql: Optional[str] = None,
                 pos: Optional[int] = None):
        if sql is not None and pos is not None:
            line_start = sql.rfind("\n", 0, pos) + 1
            line_end = sql.find("\n", pos)
            line_end = len(sql) if line_end < 0 else line_end
            caret = " " * (pos - line_start) + "^"
            message = f"{message}\n  {sql[line_start:line_end]}\n  {caret}"
        super().__init__(message)


KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order",
    "limit", "as", "and", "or", "not", "in", "exists", "between", "like",
    "case", "when", "then", "else", "end", "join", "inner", "left", "outer",
    "on", "asc", "desc", "date", "interval", "year", "month", "day",
    "extract", "substring", "for", "cast", "is", "null", "true", "false",
}

# token kinds
KW, IDENT, NUM, STR, OP, EOF = "kw", "ident", "num", "str", "op", "eof"

_TWO_CHAR_OPS = ("<=", ">=", "<>", "!=")
_ONE_CHAR_OPS = "=<>+-*/(),.;"


@dataclasses.dataclass
class Token:
    kind: str
    value: object          # str for kw/ident/op/str, int|float for num
    pos: int

    def is_kw(self, *names: str) -> bool:
        return self.kind == KW and self.value in names

    def is_op(self, *ops: str) -> bool:
        return self.kind == OP and self.value in ops


def tokenize(sql: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):                      # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "'":                                     # string literal
            j, parts = i + 1, []
            while True:
                if j >= n:
                    raise SqlError("unterminated string literal", sql, i)
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # '' escape
                        parts.append("'")
                        j += 2
                        continue
                    break
                parts.append(sql[j])
                j += 1
            toks.append(Token(STR, "".join(parts), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            is_float = False
            while j < n and (sql[j].isdigit() or sql[j] == "."):
                is_float |= sql[j] == "."
                j += 1
            text = sql[i:j]
            if text.count(".") > 1:
                raise SqlError(f"bad number {text!r}", sql, i)
            toks.append(Token(NUM, float(text) if is_float else int(text), i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j].lower()
            toks.append(Token(KW if word in KEYWORDS else IDENT, word, i))
            i = j
            continue
        two = sql[i:i + 2]
        if two in _TWO_CHAR_OPS:
            toks.append(Token(OP, two, i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            toks.append(Token(OP, c, i))
            i += 1
            continue
        raise SqlError(f"unexpected character {c!r}", sql, i)
    toks.append(Token(EOF, None, n))
    return toks
