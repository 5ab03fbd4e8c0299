"""Fleet-level query journal: structured spans keyed by query ID.

Counterpart of ``repro/observability/journal.py``, with the same
environment variables, so one deployment configures both packages alike.
The tracer, metrics and profile attribute time *inside one engine in one
process*; this module is the fleet-level complement: a process-wide,
**always-on**, append-only event journal whose unit of correlation is a
**query ID** minted at every front door (``engine.sql``,
``engine.accelerate``, ``engine.execute``) and threaded — via an explicit
``TraceContext`` — across threads, speculative replicas, and the shard
mesh, so that every fragment attempt, per-shard engine run, collective
exchange, retry, elastic rebuild, checkpoint, and warm plan-cache replay
lands in **one tree per query** no matter which thread emitted it.

Design constraints, in order:

1. **Cheap enough to leave on.**  Emitting a span is two
   ``perf_counter`` calls, a dict, and one lock-guarded deque append.
   The journal never touches device values — every attribute is a host
   int/float/str, and a tensor passed as an attribute is described by
   its shape, dtype and device, never read (the reference's ``repr`` of
   a CUDA tensor would copy it to the host and synchronise) — so the
   one-barrier-per-query and zero-in-pipeline transfer contracts hold
   with the journal enabled.
2. **Concurrency-safe.**  The ring buffer takes one lock per event;
   span nesting state is thread-local; query IDs are process-unique.
   Concurrent queries interleave in the ring but each event carries its
   ``query_id``, so per-query views are exact.
3. **Bounded.**  A ring buffer (``REPRO_JOURNAL_CAPACITY``, default
   65536 events) with an optional JSONL sink (``attach_sink`` /
   ``REPRO_JOURNAL_SINK``) for durable export.  Ring overflow drops the
   oldest events and counts them (``dropped``).

Spans emitted outside any query context are dropped — the journal is a
*query* journal; ambient noise belongs to ``tracer``/``metrics``.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import torch

JOURNAL_SCHEMA_VERSION = 1

_ATTR_TYPES = (str, int, float, bool, type(None), list, tuple, dict)

# the process ID in query IDs, read once and again after a fork: the
# reference calls os.getpid() for every query, a system call on each warm
# run, which costs far more than the rest of the journal on a host where
# system calls are slow
_PID = os.getpid()


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_refresh_pid)


@dataclass(frozen=True)
class TraceContext:
    """The wire-able slice of journal state: enough for another thread (a
    shard worker, a speculative replica, a future remote node) to attach
    its spans under the originating query's tree."""

    query_id: str
    span_id: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"query_id": self.query_id, "span_id": self.span_id}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TraceContext":
        return TraceContext(query_id=d["query_id"],
                            span_id=d.get("span_id"))


class _NoopSpan:
    """Shared do-nothing span for the disabled / no-context paths."""

    __slots__ = ()
    query_id = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class JournalSpan:
    """A live span: context manager that commits one event on exit."""

    __slots__ = ("_journal", "name", "category", "query_id", "span_id",
                 "parent_id", "attrs", "start", "_tid")

    def __init__(self, journal: "QueryJournal", name: str, category: str,
                 query_id: str, span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self._journal = journal
        self.name = name
        self.category = category
        self.query_id = query_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.start = 0.0
        self._tid = 0

    def __enter__(self) -> "JournalSpan":
        self._journal._push(self)
        self._tid = threading.get_ident()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = time.perf_counter()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._journal._pop(self)
        self._journal._commit({
            "kind": "span", "name": self.name, "cat": self.category,
            "query_id": self.query_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "ts": self.start,
            "dur": end - self.start, "tid": self._tid,
            "attrs": self.attrs,
        })
        return False

    def set(self, **attrs) -> "JournalSpan":
        """Attach host-side attributes (never device values) to the span."""
        self.attrs.update(attrs)
        return self


class QueryJournal:
    """Thread-safe ring buffer of query-scoped span/instant events."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        if capacity is None:
            capacity = int(os.environ.get("REPRO_JOURNAL_CAPACITY", 65536))
        if enabled is None:
            enabled = os.environ.get("REPRO_JOURNAL_DISABLE", "0") != "1"
        self.capacity = capacity
        self.enabled = enabled
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._qseq = itertools.count(1)
        self._local = threading.local()
        # perf_counter origin so event timestamps are small positive floats
        # comparable across threads; wall anchor for JSONL consumers.
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self._sink = None
        self._sink_lock = threading.Lock()
        sink = os.environ.get("REPRO_JOURNAL_SINK")
        if sink:
            self.attach_sink(sink)

    # -- enable / sink -----------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def attach_sink(self, path: str) -> None:
        """Mirror every committed event to ``path`` as one JSON line
        (schema_version stamped per line so files are self-describing)."""
        with self._sink_lock:
            if self._sink is not None:
                self._sink.close()
            self._sink = open(path, "a", encoding="utf-8")

    def detach_sink(self) -> None:
        with self._sink_lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None

    # -- context plumbing --------------------------------------------------

    def _stack(self) -> List:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: JournalSpan) -> None:
        self._stack().append(span)

    def _pop(self, span: JournalSpan) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:          # tolerate out-of-order exits
            st.remove(span)

    def _top(self) -> Optional[JournalSpan]:
        """The innermost open span (or activated anchor) on this thread."""
        st = getattr(self._local, "stack", None)
        return st[-1] if st else None

    def current_context(self) -> Optional[TraceContext]:
        """The ambient (query_id, span_id) on this thread, or None."""
        top = self._top()
        if top is None:
            return None
        return TraceContext(query_id=top.query_id, span_id=top.span_id)

    @contextmanager
    def activate(self, ctx: Optional[TraceContext]):
        """Adopt a remote/parent ``TraceContext`` on this thread: spans
        opened inside attach under ``ctx.span_id`` in ``ctx.query_id``'s
        tree.  This is the propagation primitive the distributed runner
        uses to carry the coordinator's context onto fragment worker
        threads and speculative replicas."""
        if ctx is None or not self.enabled:
            yield
            return
        anchor = JournalSpan(self, "<ctx>", "ctx", ctx.query_id,
                             ctx.span_id if ctx.span_id is not None else 0,
                             None, {})
        # The anchor is bookkeeping only: it parents children but is never
        # committed as an event (the real span lives on the origin thread).
        self._push(anchor)
        try:
            yield
        finally:
            self._pop(anchor)

    # -- emission ----------------------------------------------------------

    def new_query_id(self, prefix: str = "q") -> str:
        return f"{prefix}{_PID}-{next(self._qseq)}"

    def query_span(self, name: str, query_id: Optional[str] = None,
                   **attrs):
        """Front-door span.  If a journal context is already active on
        this thread (nested engine call, shard run under an activated
        fragment context) this is an ordinary child span; otherwise it
        roots a fresh query tree with a newly minted query ID."""
        if not self.enabled:
            return _NOOP
        cur = self._top()
        if cur is not None:
            return JournalSpan(self, name, attrs.pop("category", "engine"),
                               cur.query_id, next(self._ids), cur.span_id,
                               self._clean(attrs))
        qid = query_id or self.new_query_id()
        return JournalSpan(self, name, "query", qid, next(self._ids), None,
                           self._clean(attrs))

    def span(self, name: str, category: str = "other", **attrs):
        """Child span under the ambient context; dropped when no query is
        active on this thread (the journal records queries, not noise)."""
        if not self.enabled:
            return _NOOP
        cur = self._top()
        if cur is None:
            return _NOOP
        return JournalSpan(self, name, category, cur.query_id,
                           next(self._ids), cur.span_id, self._clean(attrs))

    def event(self, name: str, category: str = "other", **attrs) -> None:
        """Zero-duration instant event under the ambient context."""
        if not self.enabled:
            return
        cur = self._top()
        if cur is None:
            return
        self._commit({
            "kind": "instant", "name": name, "cat": category,
            "query_id": cur.query_id, "span_id": next(self._ids),
            "parent_id": cur.span_id, "ts": time.perf_counter(),
            "dur": 0.0, "tid": threading.get_ident(),
            "attrs": self._clean(attrs),
        })

    @staticmethod
    def _clean(attrs: Dict[str, Any]) -> Dict[str, Any]:
        # Journal attributes must be host-plain (JSON-able, no device
        # arrays): a tensor by its metadata alone (no read, no sync),
        # numpy scalars via item(), anything exotic by repr.
        out = {}
        for k, v in attrs.items():
            if isinstance(v, _ATTR_TYPES):
                out[k] = v
            elif isinstance(v, torch.Tensor):
                out[k] = (f"Tensor(shape={tuple(v.shape)}, dtype={v.dtype}, "
                          f"device={v.device})")
            elif hasattr(v, "item") and not hasattr(v, "__len__"):
                try:
                    out[k] = v.item()
                except Exception:
                    out[k] = repr(v)
            else:
                out[k] = repr(v)
        return out

    def _commit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
        sink = self._sink
        if sink is not None:
            line = json.dumps(
                {"schema_version": JOURNAL_SCHEMA_VERSION, **ev},
                default=str)
            with self._sink_lock:
                if self._sink is not None:
                    self._sink.write(line + "\n")
                    self._sink.flush()

    # -- reading -----------------------------------------------------------

    def events(self, query_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """Point-in-time snapshot, optionally filtered to one query."""
        with self._lock:
            evs = list(self._events)
        if query_id is not None:
            evs = [e for e in evs if e["query_id"] == query_id]
        return evs

    def query_ids(self) -> List[str]:
        """Distinct query IDs currently in the ring, oldest first."""
        seen: Dict[str, None] = {}
        for e in self.events():
            seen.setdefault(e["query_id"], None)
        return list(seen)

    def summary(self, query_id: Optional[str] = None) -> Dict[str, Any]:
        """Event counts by category — the cheap health view benchmarks
        embed next to their timings."""
        evs = self.events(query_id)
        by_cat: Dict[str, int] = {}
        for e in evs:
            by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + 1
        return {"events": len(evs), "dropped": self.dropped,
                "by_category": dict(sorted(by_cat.items()))}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing loadable)
# ---------------------------------------------------------------------------


def _chrome_pid(ev: Dict[str, Any],
                by_id: Dict[int, Dict[str, Any]]) -> int:
    """Process lane: coordinator/engine events in pid 0, shard-s work in
    pid s+1 — mirrors the physical layout of a shard mesh.  Events with
    no shard attribute of their own inherit the nearest ancestor's (a
    shard engine's inner spans belong on that shard's track)."""
    hops = 0
    while ev is not None and hops < 64:
        shard = ev.get("attrs", {}).get("shard")
        if isinstance(shard, int):
            return shard + 1
        ev = by_id.get(ev.get("parent_id"))
        hops += 1
    return 0


def to_chrome(events: Iterable[Dict[str, Any]],
              epoch: float = 0.0) -> Dict[str, Any]:
    """Render journal events as a Chrome trace-event JSON dict.

    Spans become complete events (``ph: "X"``, µs timestamps), instants
    become ``ph: "i"``; process/thread lanes get metadata names so
    Perfetto shows "coordinator" / "shard N" tracks."""
    events = list(events)
    by_id = {e["span_id"]: e for e in events}
    trace: List[Dict[str, Any]] = []
    lanes: Dict[int, None] = {}
    tids: Dict[int, int] = {}
    for ev in events:
        pid = _chrome_pid(ev, by_id)
        lanes.setdefault(pid, None)
        tid = tids.setdefault(ev.get("tid", 0), len(tids) + 1)
        args = {"query_id": ev["query_id"], **ev.get("attrs", {})}
        base = {"name": ev["name"], "cat": ev["cat"],
                "ts": (ev["ts"] - epoch) * 1e6, "pid": pid, "tid": tid,
                "args": args}
        if ev["kind"] == "span":
            trace.append({**base, "ph": "X",
                          "dur": max(ev["dur"], 1e-7) * 1e6})
        else:
            trace.append({**base, "ph": "i", "s": "t"})
    for pid in sorted(lanes):
        trace.append({"ph": "M", "name": "process_name", "pid": pid,
                      "tid": 0, "args": {
                          "name": "coordinator" if pid == 0
                          else f"shard {pid - 1}"}})
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "otherData": {"schema_version": JOURNAL_SCHEMA_VERSION}}


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read a JSONL sink file back into event dicts."""
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# The process-wide journal every front door writes into.
JOURNAL = QueryJournal()
