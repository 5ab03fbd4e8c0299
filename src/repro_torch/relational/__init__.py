"""Relational operator substrate on torch tensors."""
from .table import Column, Table, date_to_days, days_to_date, unify_string_keys  # noqa: F401
from .expressions import (  # noqa: F401
    Between, BinOp, Case, Cast, Col, DateLit, Expr, ExtractYear, InList, Like,
    Lit, StartsWith, Substr, UnOp, evaluate,
)
from .join import combine_keys, hash_join  # noqa: F401
from .aggregate import AggSpec, group_aggregate  # noqa: F401
from .sort import SortKey, sort_table  # noqa: F401
