"""Substrait-style plan interchange + hybrid drop-in acceleration layer —
counterpart of ``repro/substrait``.

This package is the serialization boundary that makes the engine *drop-in*
(paper §3.1): a host database emits a standard plan representation, the
accelerator consumes it, and anything the accelerator cannot run degrades
to hybrid execution on the host fallback instead of erroring.

Public surface:

* ``emit(plan, catalog=None) -> dict`` — plan IR → Substrait-shaped wire
  dict (versioned, function-registry URIs, schema blocks).
* ``ingest(wire) -> Rel`` — wire dict / JSON text → plan IR; raises
  ``SubstraitError`` with a document path on any violation.
* ``wire_bytes(wire) -> bytes`` — the canonical byte serialization
  (compact, key-sorted; golden files store exactly these bytes).
* ``CapabilityRegistry`` / ``DEFAULT_REGISTRY`` — the per-rel / per-expr
  device-capability table.
* ``HybridRouter`` / ``explain_fragments`` — fragment splitting + two-engine
  execution with boundary-transfer accounting.

The engine front door is ``SiriusEngine.accelerate(wire_plan)``; the host
producer is ``repro_torch.sql.sql_to_wire``.  The wire bytes are the
reference's, byte for byte: a plan emitted by either package ingests in
the other.
"""
from __future__ import annotations

from .registry import (
    DEFAULT_REGISTRY, DEVICE_EXPRS, DEVICE_RELS, EXTENSION_URIS, FUNCTIONS,
    CapabilityRegistry,
)
from .router import Fragment, HybridRouter, explain_fragments
from .wire import SubstraitError, emit, ingest, wire_bytes

__all__ = [
    "CapabilityRegistry", "DEFAULT_REGISTRY", "DEVICE_EXPRS", "DEVICE_RELS",
    "EXTENSION_URIS", "FUNCTIONS", "Fragment", "HybridRouter",
    "SubstraitError", "emit", "explain_fragments", "ingest", "wire_bytes",
]
