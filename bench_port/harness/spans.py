"""Reading the query journal's spans of a window (``observability/journal.py``
events of the client's thread: ``name``, ``span_id``, ``parent_id``,
``dur`` in seconds)."""
from __future__ import annotations

from typing import Dict, List


def outermost(spans: List[dict], name: str) -> List[dict]:
    """Spans called ``name`` with no ancestor of that name (a nested
    scalar subquery's span is part of its query's)."""
    by_id: Dict[int, dict] = {s["span_id"]: s for s in spans}
    out = []
    for s in spans:
        if s["name"] != name:
            continue
        p = by_id.get(s["parent_id"])
        while p is not None and p["name"] != name:
            p = by_id.get(p["parent_id"])
        if p is None:
            out.append(s)
    return out


def self_time(spans: List[dict], name: str, child: str) -> List[float]:
    """Each root span ``name``'s duration less its direct ``child`` spans."""
    roots = {s["span_id"]: s["dur"] for s in spans
             if s["name"] == name and s["parent_id"] is None}
    for s in spans:
        if s["name"] == child and s["parent_id"] in roots:
            roots[s["parent_id"]] -= s["dur"]
    return list(roots.values())
