"""Hybrid execution router: maximal device fragments + host fallback —
counterpart of ``repro/substrait/router.py``.

The drop-in contract (paper §3.2.2): when a plan contains a rel or
expression the accelerator engine cannot execute, Sirius does not error —
the host engine keeps those operators and only the supported fragments run
on the device.  This module reproduces that split for ingested plans:

1. every node gets a placement from the ``CapabilityRegistry``
   (device-capable or host-only);
2. maximal same-placement subtrees become **fragments**; each cut edge is a
   boundary scan (``ReadRel`` on a ``__substrait_frag<N>`` temp table);
3. fragments execute in dependency order — device fragments on the
   ``SiriusEngine`` pipeline executor, host fragments on the numpy oracle
   (``core.fallback.FallbackEngine``);
4. every table that crosses the boundary is accounted: device→host via
   ``BufferManager.account_boundary_to_host``, host→device via the buffer
   manager's cold-copy path plus ``account_boundary_to_device`` — so tests
   can assert that a pure-device plan moves zero boundary bytes and a
   hybrid plan moves exactly its cut-edge tables.

A host fragment's result that feeds a device fragment is cached on the
engine's device through the buffer manager (never left on the CPU), and
temp tables never go through ``SiriusEngine.register``, which would drop
every cached plan.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from ..core.plan import (
    HYBRID_BOUNDARY_PREFIX, ReadRel, Rel, explain, walk_deep,
)
from ..observability.metrics import METRICS
from ..relational.table import Column, Table
from .registry import DEFAULT_REGISTRY, CapabilityRegistry


@dataclasses.dataclass
class Fragment:
    """One routed plan piece: a subtree of uniform placement whose leaf
    boundary scans read other fragments' materialized results."""
    fid: int
    plan: Rel
    placement: str                      # "device" | "host"
    deps: List[int]
    rel_count: int                      # own rels (boundary scans excluded)


def _boundary_name(fid: int) -> str:
    return f"{HYBRID_BOUNDARY_PREFIX}{fid}"


def _is_boundary(rel: Rel) -> bool:
    return isinstance(rel, ReadRel) and \
        rel.table.startswith(HYBRID_BOUNDARY_PREFIX)


def host_to_device(host: Dict[str, Any], device) -> Table:
    """A host-format table as a ``Table`` on ``device`` (``from_pydict``
    builds CPU tensors, the host format)."""
    t = Table.from_pydict(host)
    return Table({n: Column(c.data.to(device), c.kind, c.dictionary)
                  for n, c in t.columns.items()})


class HybridRouter:
    """Splits a plan by capability and drives the two engines."""

    def __init__(self, engine, registry: Optional[CapabilityRegistry] = None):
        self.engine = engine
        self.registry = registry or DEFAULT_REGISTRY

    # -- planning ----------------------------------------------------------
    def plan_fragments(self, plan: Rel) -> List[Fragment]:
        """Cut the plan into maximal same-placement fragments (pure —
        no execution, no engine state).  The root fragment is last."""
        registry = self.registry
        fragments: List[Fragment] = []

        def make(root: Rel) -> int:
            placement = registry.placement(root)
            deps: List[int] = []

            def rewrite(node: Rel) -> Rel:
                if registry.placement(node) != placement:
                    fid = make(node)
                    deps.append(fid)
                    return ReadRel(_boundary_name(fid))
                changes = {}
                for f in dataclasses.fields(node):
                    v = getattr(node, f.name)
                    if isinstance(v, Rel):
                        nv = rewrite(v)
                        if nv is not v:
                            changes[f.name] = nv
                    elif isinstance(v, list) and \
                            any(isinstance(x, Rel) for x in v):
                        changes[f.name] = [
                            rewrite(x) if isinstance(x, Rel) else x
                            for x in v]
                return dataclasses.replace(node, **changes) if changes \
                    else node

            new_root = rewrite(root)
            n_rels = sum(1 for r in walk_deep(new_root)
                         if not _is_boundary(r))
            frag = Fragment(len(fragments), new_root, placement, deps, n_rels)
            fragments.append(frag)
            return frag.fid

        make(plan)
        return fragments

    def device_fragment_fraction(self, plan: Rel) -> float:
        """Fraction of plan rels the device engine owns after routing
        (1.0 = fully device-resident, the paper's happy path)."""
        frags = self.plan_fragments(plan)
        total = sum(f.rel_count for f in frags)
        dev = sum(f.rel_count for f in frags if f.placement == "device")
        return dev / total if total else 1.0

    # -- execution ---------------------------------------------------------
    def execute(self, plan: Rel,
                analyze: bool = False) -> Tuple[Any, Dict[str, Any]]:
        """Run ``plan`` hybrid.  Returns (result, report): the result is a
        device ``Table`` when the root fragment ran on device, a host dict
        otherwise; the report carries fragment placements and boundary
        traffic.  With ``analyze=True`` each fragment entry also gets its
        wall-clock ``seconds`` and ``rows_out``, and a device fragment its
        per-operator ``QueryProfile`` under ``"_profile"`` (popped by
        ``SiriusEngine.accelerate`` when it merges the query's profile)."""
        from ..core.fallback import FallbackEngine

        fragments = self.plan_fragments(plan)
        buffers = self.engine.buffers
        results: Dict[int, Any] = {}
        frag_info: Dict[int, Dict[str, Any]] = {}
        temp_names: List[str] = []
        to_host_bytes = to_device_bytes = 0
        try:
            for frag in fragments:
                METRICS.counter(f"router.{frag.placement}_fragments").inc()
                t_frag = time.perf_counter()
                if frag.placement == "device":
                    for d in frag.deps:
                        dep = results[d]
                        if not isinstance(dep, Table):
                            dep = Table.from_pydict(dep)
                            to_device_bytes += dep.nbytes
                            buffers.account_boundary_to_device(dep.nbytes)
                        name = _boundary_name(d)
                        # (cache_table copies it onto the engine's device)
                        buffers.cache_table(name, dep)
                        temp_names.append(name)
                    executor = self.engine.executor
                    # fragments that scan boundary temp tables must bypass
                    # the executable-plan cache: the temp contents change
                    # across accelerate() calls while the fragment's plan
                    # signature stays identical
                    prev_cache = executor.cache_enabled
                    executor.cache_enabled = prev_cache and not frag.deps
                    try:
                        out: Any = executor.execute(frag.plan,
                                                    analyze=analyze)
                    finally:
                        executor.cache_enabled = prev_cache
                    if analyze:
                        frag_info[frag.fid] = {
                            "_profile": executor.last_profile}
                else:
                    host_tables = dict(self.engine.host_tables)
                    for d in frag.deps:
                        dep = results[d]
                        if isinstance(dep, Table):
                            buffers.account_boundary_to_host(dep.nbytes)
                            to_host_bytes += dep.nbytes
                            dep = dep.to_host()
                        host_tables[_boundary_name(d)] = dep
                    for rel in walk_deep(frag.plan):
                        # base tables this host fragment scans but the host
                        # side never saw: decode from the device cache
                        if isinstance(rel, ReadRel) and \
                                rel.table not in host_tables:
                            dev = buffers.get(rel.table)
                            buffers.account_boundary_to_host(dev.nbytes)
                            to_host_bytes += dev.nbytes
                            host_tables[rel.table] = dev.to_host()
                    out = FallbackEngine(host_tables).execute(frag.plan)
                results[frag.fid] = out
                if analyze:
                    info = frag_info.setdefault(frag.fid, {})
                    info["seconds"] = time.perf_counter() - t_frag
                    info["rows_out"] = (
                        out.num_rows if isinstance(out, Table)
                        else len(next(iter(out.values()), [])))
        finally:
            for name in temp_names:
                buffers.drop(name)
        total_rels = sum(f.rel_count for f in fragments)
        device_rels = sum(f.rel_count for f in fragments
                          if f.placement == "device")
        report = {
            "fragments": [dict({"fid": f.fid, "placement": f.placement,
                                "rels": f.rel_count, "deps": list(f.deps)},
                               **frag_info.get(f.fid, {}))
                          for f in fragments],
            "device_fragments": sum(1 for f in fragments
                                    if f.placement == "device"),
            "host_fragments": sum(1 for f in fragments
                                  if f.placement == "host"),
            "device_rel_fraction": device_rels / total_rels
            if total_rels else 1.0,
            "boundary_to_host_bytes": to_host_bytes,
            "boundary_to_device_bytes": to_device_bytes,
        }
        return results[fragments[-1].fid], report


def explain_fragments(fragments: List[Fragment]) -> str:
    """Human-readable routed plan: one block per fragment, hybrid boundary
    scans marked inline by ``explain`` (the EXPLAIN counterpart of the
    paper's fallback observability)."""
    blocks = []
    for f in fragments:
        head = f"Fragment {f.fid} [{f.placement}]"
        if f.deps:
            head += f" deps={f.deps}"
        body = "\n".join("  " + line
                         for line in explain(f.plan).splitlines())
        blocks.append(head + "\n" + body)
    return "\n".join(blocks)
