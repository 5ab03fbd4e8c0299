"""Lightweight span tracer: nested wall-clock attribution, near-free when off.

Counterpart of ``repro/observability/tracer.py``, the same semantics.

A ``Span`` is a named timed interval with arbitrary attributes and an
optional parent — the minimal vocabulary needed to reconstruct "where did
this query's time go" as a tree.  Spans are entered as context managers;
nesting within one thread is tracked through a thread-local stack, and a
parent can be passed explicitly when a child span starts on a different
thread (the executor's worker threads do exactly that).

Cost model: when the tracer is disabled, ``span()`` returns a shared no-op
context manager — no allocation, no clock read, no lock — so instrumented
code paths can stay instrumented in production.  When enabled, finished
spans are appended to a lock-protected list; ``finished()`` returns them
oldest-first.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


class Span:
    """One timed interval.  ``seconds`` is valid once the span has exited."""

    __slots__ = ("name", "category", "attrs", "parent", "start", "end",
                 "_tracer")

    def __init__(self, tracer: "SpanTracer", name: str, category: str,
                 parent: Optional["Span"], attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.category = category
        self.parent = parent
        self.attrs = attrs
        self.start = 0.0
        self.end = 0.0

    @property
    def seconds(self) -> float:
        return max(self.end - self.start, 0.0)

    def set(self, **attrs: Any) -> None:
        """Attach attributes mid-span (rows out, cache hit...)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        self._tracer._pop(self)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "category": self.category,
                "seconds": self.seconds,
                "parent": self.parent.name if self.parent else None,
                "attrs": dict(self.attrs)}


class _NoopSpan:
    """Shared disabled-path span: every operation is a no-op."""

    __slots__ = ()

    seconds = 0.0

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()


class SpanTracer:
    """Thread-safe span collector; disabled by default."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._finished: List[Span] = []
        self._local = threading.local()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, category: str = "other",
             parent: Optional[Span] = None, **attrs: Any):
        """Open a span as a context manager.

        When the tracer is disabled this returns a shared no-op object —
        the call costs one attribute read and one comparison.
        """
        if not self.enabled:
            return _NOOP
        if parent is None:
            parent = self.current()
        return Span(self, name, category, parent, attrs)

    def current(self) -> Optional[Span]:
        """The innermost open span on *this* thread (None outside spans)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        with self._lock:
            self._finished.append(span)

    # -- inspection ----------------------------------------------------------
    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False


# Process-wide default tracer (disabled until a profiling entry point —
# analyze=True / EXPLAIN ANALYZE — turns it on for the duration of a query).
TRACER = SpanTracer()
