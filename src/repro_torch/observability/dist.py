"""Distributed-trace analysis: merge shard spans into one query tree.

Counterpart of ``repro/observability/dist.py``: pure functions over
journal events, ported whole.  The port has no exchange yet, so
``exchange_report`` finds no rows on its own queries.

The journal collects raw events from every thread — coordinator loop,
fragment workers, speculative replicas, per-shard engines.  This module
turns one query's events into the artifacts the tooling serves:

* ``span_tree``        — parent-linked tree (children time-ordered);
* ``render_timeline``  — indented text timeline with wall times;
* ``top_operators``    — aggregate wall time by span name;
* ``exchange_report``  — per-exchange bytes-per-shard and skew table;
* ``verify_tree``      — structural/temporal integrity checks used by
  ``scripts/trace_report.py`` to cross-check the journal against
  ``QueryProfile`` totals.

Skew metric (DESIGN.md §15): for an exchange whose per-shard byte
contributions are ``b``, ``skew_ratio = max(b) / mean(b)`` — 1.0 is a
perfectly balanced exchange, ``n_shards`` is one shard carrying
everything.  For shuffles the *received* (post-partition) distribution is
what stalls the mesh, so that is what the runner records.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple


def skew_ratio(bytes_per_shard: Iterable[float]) -> float:
    """max/mean of a per-shard byte distribution; 1.0 when empty/uniform."""
    vals = [float(b) for b in bytes_per_shard]
    if not vals:
        return 1.0
    mean = sum(vals) / len(vals)
    if mean <= 0:
        return 1.0
    return max(vals) / mean


class SpanNode:
    __slots__ = ("event", "children")

    def __init__(self, event: Dict[str, Any]):
        self.event = event
        self.children: List["SpanNode"] = []

    @property
    def name(self) -> str:
        return self.event["name"]

    @property
    def dur(self) -> float:
        return self.event["dur"]


def span_tree(events: List[Dict[str, Any]],
              query_id: Optional[str] = None) -> List[SpanNode]:
    """Merge one query's events into parent-linked root nodes.

    Spans commit on *exit*, so parents land in the ring after their
    children; linking is by ``parent_id``, not arrival order.  Events
    whose parent never committed (e.g. still-open spans at snapshot time,
    or ring-evicted parents) surface as extra roots rather than being
    dropped."""
    if query_id is not None:
        events = [e for e in events if e["query_id"] == query_id]
    nodes = {e["span_id"]: SpanNode(e) for e in events}
    roots: List[SpanNode] = []
    for e in events:
        node = nodes[e["span_id"]]
        parent = nodes.get(e.get("parent_id"))
        if parent is not None and parent is not node:
            parent.children.append(node)
        else:
            roots.append(node)
    for n in nodes.values():
        n.children.sort(key=lambda c: c.event["ts"])
    roots.sort(key=lambda c: c.event["ts"])
    return roots


def render_timeline(events: List[Dict[str, Any]],
                    query_id: Optional[str] = None,
                    epoch: float = 0.0) -> str:
    """Indented text timeline of one query's span tree."""
    lines: List[str] = []

    def walk(node: SpanNode, depth: int) -> None:
        e = node.event
        t0 = (e["ts"] - epoch) * 1e3
        attrs = e.get("attrs", {})
        extra = " ".join(
            f"{k}={attrs[k]}" for k in ("fragment", "shard", "attempt",
                                        "kind", "replica", "skew_ratio")
            if k in attrs)
        marker = "·" if e["kind"] == "instant" else "▸"
        lines.append(f"{'  ' * depth}{marker} {e['name']:<34} "
                     f"+{t0:9.3f}ms {e['dur'] * 1e3:9.3f}ms"
                     f"{('  ' + extra) if extra else ''}")
        for c in node.children:
            walk(c, depth + 1)

    for root in span_tree(events, query_id):
        walk(root, 0)
    return "\n".join(lines)


def top_operators(events: List[Dict[str, Any]],
                  query_id: Optional[str] = None,
                  n: int = 15) -> List[Dict[str, Any]]:
    """Aggregate span wall time by name (spans only, instants skipped)."""
    if query_id is not None:
        events = [e for e in events if e["query_id"] == query_id]
    agg: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e["kind"] != "span":
            continue
        row = agg.setdefault(e["name"], {"name": e["name"], "cat": e["cat"],
                                         "count": 0, "total_s": 0.0,
                                         "max_s": 0.0})
        row["count"] += 1
        row["total_s"] += e["dur"]
        row["max_s"] = max(row["max_s"], e["dur"])
    return sorted(agg.values(), key=lambda r: -r["total_s"])[:n]


def render_top_operators(rows: List[Dict[str, Any]]) -> str:
    lines = [f"{'span':<36} {'cat':<10} {'count':>5} {'total_ms':>10} "
             f"{'max_ms':>10}"]
    for r in rows:
        lines.append(f"{r['name']:<36} {r['cat']:<10} {r['count']:>5} "
                     f"{r['total_s'] * 1e3:>10.3f} {r['max_s'] * 1e3:>10.3f}")
    return "\n".join(lines)


def exchange_report(events: List[Dict[str, Any]],
                    query_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """One row per collective exchange span: kind, key, per-shard bytes,
    skew ratio — the 'exchange volume and skew' view the terabyte-scale
    paper argues is the distributed story."""
    if query_id is not None:
        events = [e for e in events if e["query_id"] == query_id]
    rows = []
    for e in events:
        if e["kind"] != "span" or e["cat"] != "exchange":
            continue
        a = e.get("attrs", {})
        rows.append({
            "fragment": a.get("fragment", "?"),
            "kind": a.get("kind", "?"),
            "key": a.get("key"),
            "bytes_per_shard": a.get("bytes_per_shard", []),
            "skew_ratio": a.get("skew_ratio", 1.0),
            "wall_s": e["dur"],
        })
    rows.sort(key=lambda r: -sum(r["bytes_per_shard"] or [0]))
    return rows


def render_exchange_report(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return "(no exchanges)"
    lines = [f"{'fragment':<22} {'kind':<10} {'key':<16} {'bytes':>12} "
             f"{'skew':>6} {'wall_ms':>9}  per-shard bytes"]
    for r in rows:
        bps = r["bytes_per_shard"] or []
        lines.append(
            f"{r['fragment']:<22} {r['kind']:<10} "
            f"{str(r['key'] or '-'):<16} {int(sum(bps)):>12} "
            f"{r['skew_ratio']:>6.2f} {r['wall_s'] * 1e3:>9.3f}  "
            f"{[int(b) for b in bps]}")
    return "\n".join(lines)


def verify_tree(events: List[Dict[str, Any]], query_id: str,
                slack_s: float = 0.005) -> List[str]:
    """Structural + temporal integrity checks over one query's tree.

    Returns a list of violations (empty == healthy):
    * every event carries the query ID;
    * span IDs are unique;
    * linked children fall inside their parent's wall-clock window
      (within ``slack_s`` — span commit order means the parent's window
      is measured on a different thread for propagated contexts);
    * each root's direct children don't sum to more than the root's
      wall (plus slack) unless they overlap (parallel shard spans on one
      parent are expected and exempt).
    """
    evs = [e for e in events if e["query_id"] == query_id]
    errors: List[str] = []
    if not evs:
        return [f"no events for query {query_id}"]
    seen_ids = set()
    for e in evs:
        if e["span_id"] in seen_ids:
            errors.append(f"duplicate span_id {e['span_id']}")
        seen_ids.add(e["span_id"])
    by_id = {e["span_id"]: e for e in evs}
    for e in evs:
        pid = e.get("parent_id")
        if pid is None:
            continue
        p = by_id.get(pid)
        if p is None:
            continue  # parent evicted or uncommitted — tree handles it
        if p["query_id"] != e["query_id"]:
            errors.append(
                f"span {e['span_id']} parent crosses query boundary")
        if p["kind"] != "span":
            continue
        if e["cat"] == "attempt":
            # replica spans race each other past the fragment span's exit
            # by design (a losing primary or a speculative backup keeps
            # running after the winner commits) — the fragment→attempt
            # edge is structural only; edges *inside* each attempt are
            # still window-checked against the attempt span itself
            continue
        if e["ts"] < p["ts"] - slack_s or \
                e["ts"] + e["dur"] > p["ts"] + p["dur"] + slack_s:
            errors.append(
                f"span {e['name']}#{e['span_id']} "
                f"[{e['ts']:.6f},{e['ts'] + e['dur']:.6f}] outside parent "
                f"{p['name']}#{pid} [{p['ts']:.6f},{p['ts'] + p['dur']:.6f}]")
    return errors


def query_wall(events: List[Dict[str, Any]],
               query_id: str) -> Tuple[float, Optional[Dict[str, Any]]]:
    """(root span wall seconds, root event) for one query — the number
    ``trace_report`` cross-checks against QueryProfile.total_seconds."""
    roots = [e for e in events
             if e["query_id"] == query_id and e.get("parent_id") is None
             and e["kind"] == "span"]
    if not roots:
        return 0.0, None
    root = max(roots, key=lambda e: e["dur"])
    return root["dur"], root
