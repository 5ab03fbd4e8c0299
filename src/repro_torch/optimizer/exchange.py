"""Exchange-placement optimizer pass + distributed fragment cutting —
counterpart of ``repro/optimizer/exchange.py`` (pure Python; the placed
plans are the reference's, byte for byte through ``plan_to_json``).

The distributed lifecycle the paper describes for Doris+Sirius (and that
"Terabyte-Scale Analytics in the Blink of an Eye" / "Accelerating Presto
with GPUs" both share): the optimizer decides *at plan time* where rows
must move, inserts explicit exchange operators, and the engine executes the
plan as compiled fragments glued together by collectives.

This module is that plan-time half:

* :func:`place_exchanges` walks an optimized single-node plan tracking the
  **partitioning state** of every intermediate —

  - ``hash(k)``   rows hash-partitioned across shards on column ``k``
  - ``rr``        rows disjoint across shards, but on no useful key
  - ``rep``       every shard holds a full replica
  - ``coord``     rows only exist merged on the coordinator

  and inserts ``ExchangeRel`` boundaries (shuffle / broadcast / merge)
  where an operator's distribution requirement is not already met.  The
  build-side-selection rule uses the stats layer: a build side whose
  estimated replication cost ``est_build * (n_shards-1)`` is below the
  probe's estimated rows is broadcast; otherwise both sides are
  hash-partitioned onto a shared join key.  Group-bys either reuse an
  existing partitioning, or — when every aggregate decomposes — run as
  partial aggregation per shard, shuffle the (small) partials on a group
  key, and finalize after the exchange (``avg`` decomposes into sum/count,
  the case the paper's prototype lacked).  Order-dependent tails (sort,
  fetch, window over foreign partitionings, global aggregates) merge to the
  coordinator.

* :func:`cut_fragments` cuts the exchanged plan at every ``ExchangeRel``
  into dependency-ordered :class:`ExchangeFragment`\\ s — the same
  recursive boundary-scan rewrite the hybrid router uses, with each cut
  edge becoming a ``ReadRel`` on a ``__dist_frag<N>`` registry table.

Correctness rules encoded here (each one is load-bearing):

* a replicated probe over a hash-partitioned build is exact for
  inner/semi joins only; anti/left/mark joins would emit their
  non-matching probe rows once per shard, so those force the probe onto a
  disjoint partitioning first;
* a probe on ``rr`` must be re-shuffled even for inner joins (its rows are
  not where their build matches live);
* shuffling on a group key makes every group complete on one shard, so all
  aggregate functions — including non-decomposable ``count_distinct`` and
  ``having`` — evaluate exactly with no combine step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.plan import (
    AggregateRel, ExchangeRel, FilterRel, JoinRel, ProjectRel, ReadRel, Rel,
    SetRel, WindowRel, walk_deep,
)
from ..relational.aggregate import AggSpec
from ..relational.expressions import BinOp, Col
from ..substrait.router import Fragment
from .stats import estimate

DIST_BOUNDARY_PREFIX = "__dist_frag"

HASH, RR, REP, COORD = "hash", "rr", "rep", "coord"

# aggregate functions with an exact partial/combine decomposition
_DECOMPOSABLE = {"sum", "count", "count_star", "min", "max", "avg"}


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """Distribution state of an intermediate result across the mesh."""

    kind: str                      # hash | rr | rep | coord
    key: Optional[str] = None      # partition column for kind == hash


@dataclasses.dataclass
class ExchangeFragment(Fragment):
    """A cut plan piece plus its *output* exchange.

    ``kind`` is how this fragment's rows leave it (``shuffle`` /
    ``broadcast`` / ``merge``; ``None`` for the root), ``run_once`` marks
    fragments whose inputs are fully replicated (executing them per shard
    would duplicate rows), and ``pt`` optionally names a committed build
    side whose keys may pre-filter this fragment's shuffle (predicate
    transfer)."""

    kind: Optional[str] = None
    keys: List[str] = dataclasses.field(default_factory=list)
    run_once: bool = False
    pt: Optional[Tuple[int, str, str]] = None   # (build fid, probe key, build key)

    @property
    def label(self) -> str:
        """Stable human-readable handle (``f<fid>_<kind>``) — the name the
        coordinator's dispatch loop, fault-injection plans, checkpoints
        and journal spans all agree on."""
        return f"f{self.fid}_{self.kind or 'final'}"


def boundary_name(fid: int) -> str:
    return f"{DIST_BOUNDARY_PREFIX}{fid}"


def is_dist_boundary(rel: Rel) -> bool:
    return isinstance(rel, ReadRel) and rel.table.startswith(DIST_BOUNDARY_PREFIX)


def _part_of(rel: Rel, default=Partitioning(RR)) -> Partitioning:
    return getattr(rel, "dist_part", default)


def _tag(rel: Rel, part: Partitioning) -> Rel:
    rel.dist_part = part
    return rel


def _shuffle(rel: Rel, key: str) -> Rel:
    ex = ExchangeRel(rel, "shuffle", [key])
    ex.dist_input_part = _part_of(rel)
    return _tag(ex, Partitioning(HASH, key))


def _broadcast(rel: Rel, keys: List[str]) -> Rel:
    ex = ExchangeRel(rel, "broadcast", list(keys))
    ex.dist_input_part = _part_of(rel)
    return _tag(ex, Partitioning(REP))


def _merge(rel: Rel) -> Rel:
    ex = ExchangeRel(rel, "merge")
    ex.dist_input_part = _part_of(rel)
    return _tag(ex, Partitioning(COORD))


def _project_part(rel: ProjectRel, p: Partitioning) -> Partitioning:
    """Track a hash partitioning through projection renames."""
    if p.kind != HASH:
        return p
    for n, e in rel.exprs:
        if n == p.key and isinstance(e, Col) and e.name == p.key:
            return p
    for n, e in rel.exprs:
        if isinstance(e, Col) and e.name == p.key:
            return Partitioning(HASH, n)
    names = [n for n, _ in rel.exprs]
    if rel.keep_input and p.key not in names:
        return p                        # key column passes through untouched
    if not rel.keep_input and p.key not in names:
        return Partitioning(RR)         # key dropped; rows still disjoint
    return Partitioning(RR)             # key name rebound to a new expression


def _decompose_aggs(aggs: List[AggSpec]):
    """partial + final AggSpecs (and avg fix-up projections) for a
    two-phase aggregation.  Returns None when not decomposable."""
    partial: List[AggSpec] = []
    final: List[AggSpec] = []
    avg_fixes: List[str] = []
    for a in aggs:
        if a.fn not in _DECOMPOSABLE:
            return None
        if a.fn == "avg":
            partial.append(AggSpec("sum", a.expr, a.name + "__psum"))
            partial.append(AggSpec("count", a.expr, a.name + "__pcnt"))
            final.append(AggSpec("sum", Col(a.name + "__psum"), a.name + "__psum"))
            final.append(AggSpec("sum", Col(a.name + "__pcnt"), a.name + "__pcnt"))
            avg_fixes.append(a.name)
        elif a.fn in ("count", "count_star"):
            partial.append(AggSpec(a.fn, a.expr, a.name))
            final.append(AggSpec("sum", Col(a.name), a.name))
        else:                           # sum / min / max combine with themselves
            partial.append(AggSpec(a.fn, a.expr, a.name))
            final.append(AggSpec(a.fn, Col(a.name), a.name))
    return partial, final, avg_fixes


def _finalize_agg(boundary: Rel, rel: AggregateRel, final, avg_fixes) -> Rel:
    """Combine step over exchanged partials, restoring the original
    output schema (group keys first, aggregates in declaration order)."""
    out: Rel = AggregateRel(boundary, list(rel.group_keys), final)
    if avg_fixes:
        exprs = [(k, Col(k)) for k in rel.group_keys]
        for a in rel.aggs:
            if a.name in avg_fixes:
                exprs.append((a.name, BinOp("/", Col(a.name + "__psum"),
                                            Col(a.name + "__pcnt"))))
            else:
                exprs.append((a.name, Col(a.name)))
        out = ProjectRel(out, exprs)
    if rel.having is not None:
        out = FilterRel(out, rel.having)
    return out


class ExchangePlacer:
    """One placement run: plan in, exchanged-and-tagged plan out."""

    def __init__(self, catalog, n_shards: int,
                 table_parts: Dict[str, Partitioning]):
        self.catalog = catalog
        self.n_shards = n_shards
        self.table_parts = table_parts

    def run(self, plan: Rel) -> Rel:
        placed = self.place(plan)
        if _part_of(placed).kind in (HASH, RR):
            placed = _merge(placed)
        return placed

    # -- per-node placement ------------------------------------------------

    def place(self, rel: Rel) -> Rel:
        fn = getattr(self, "_place_" + type(rel).__name__, None)
        if fn is not None:
            return fn(rel)
        # unknown rel: pin to the coordinator, merging any partitioned input
        changes = {}
        for f in dataclasses.fields(rel):
            v = getattr(rel, f.name)
            if isinstance(v, Rel):
                changes[f.name] = self._to_complete(self.place(v))
        out = dataclasses.replace(rel, **changes) if changes else rel
        return _tag(out, Partitioning(COORD))

    def _to_complete(self, rel: Rel) -> Rel:
        """Ensure every row of ``rel`` is visible to a single consumer
        (coordinator-complete or replicated)."""
        if _part_of(rel).kind in (REP, COORD):
            return rel
        return _merge(rel)

    def _place_ReadRel(self, rel: ReadRel) -> Rel:
        part = self.table_parts.get(rel.table, Partitioning(REP))
        return _tag(rel, part)

    def _place_FilterRel(self, rel: FilterRel) -> Rel:
        i = self.place(rel.input)
        return _tag(dataclasses.replace(rel, input=i), _part_of(i))

    def _place_ProjectRel(self, rel: ProjectRel) -> Rel:
        i = self.place(rel.input)
        out = dataclasses.replace(rel, input=i)
        return _tag(out, _project_part(rel, _part_of(i)))

    def _place_ExchangeRel(self, rel: ExchangeRel) -> Rel:
        # pre-existing exchanges (none in our plans) are transparent
        i = self.place(rel.input)
        return _tag(dataclasses.replace(rel, input=i), _part_of(i))

    def _place_JoinRel(self, rel: JoinRel) -> Rel:
        probe = self.place(rel.probe)
        build = self.place(rel.build)
        pp, bp = _part_of(probe), _part_of(build)

        if COORD in (pp.kind, bp.kind):
            out = dataclasses.replace(rel, probe=self._to_complete(probe),
                                      build=self._to_complete(build))
            return _tag(out, Partitioning(COORD))

        if bp.kind == REP:
            # build already everywhere: exact for every join kind
            out = dataclasses.replace(rel, probe=probe, build=build)
            return _tag(out, pp)

        est_p = estimate(probe, self.catalog)
        est_b = estimate(build, self.catalog)
        if est_b * max(self.n_shards - 1, 0) <= est_p:
            out = dataclasses.replace(
                rel, probe=probe,
                build=_broadcast(build, rel.build_keys))
            return _tag(out, pp)

        # hash path: co-partition both sides on one equi-key pair
        best, score = 0, -1
        for i, (pk, bk) in enumerate(zip(rel.probe_keys, rel.build_keys)):
            s = (pp == Partitioning(HASH, pk)) + (bp == Partitioning(HASH, bk))
            if s > score:
                best, score = i, s
        pk, bk = rel.probe_keys[best], rel.build_keys[best]

        if bp != Partitioning(HASH, bk):
            build = _shuffle(build, bk)
        if pp == Partitioning(HASH, pk):
            pass
        elif pp.kind == REP and rel.how in ("inner", "semi"):
            # replicated probe sees every build partition's matches exactly
            # once; wrong for anti/left/mark (misses would repeat per shard)
            pass
        else:
            probe = _shuffle(probe, pk)

        out = dataclasses.replace(rel, probe=probe, build=build)
        # either the probe ends hash(pk), or a replicated probe's matches
        # land wherever the build partition lives — hash(pk) both ways
        return _tag(out, Partitioning(HASH, pk))

    def _place_AggregateRel(self, rel: AggregateRel) -> Rel:
        i = self.place(rel.input)
        p = _part_of(i)
        if p.kind == COORD:
            return _tag(dataclasses.replace(rel, input=i), Partitioning(COORD))
        if p.kind == REP:
            return _tag(dataclasses.replace(rel, input=i), Partitioning(REP))

        if not rel.group_keys:
            # min/max partials from empty shards would contribute identity
            # values with no group row to hide behind — keep those global
            # aggregates on the coordinator
            dec = None if any(a.fn in ("min", "max") for a in rel.aggs) \
                else _decompose_aggs(rel.aggs)
            if dec is None:
                return _tag(dataclasses.replace(rel, input=self._to_complete(i)),
                            Partitioning(COORD))
            partial_specs, final_specs, avg_fixes = dec
            partial = _tag(AggregateRel(i, [], partial_specs),
                           Partitioning(RR))
            out = _finalize_agg(_merge(partial), rel, final_specs, avg_fixes)
            return _tag(out, Partitioning(COORD))

        if p.kind == HASH and p.key in rel.group_keys:
            # groups already complete per shard: every aggregate (incl.
            # count_distinct / having) evaluates exactly with no combine
            return _tag(dataclasses.replace(rel, input=i),
                        Partitioning(HASH, p.key))

        key = rel.group_keys[0]
        dec = _decompose_aggs(rel.aggs)
        if dec is None:
            # shuffle raw rows so each group lands whole on one shard
            return _tag(dataclasses.replace(rel, input=_shuffle(i, key)),
                        Partitioning(HASH, key))
        partial_specs, final_specs, avg_fixes = dec
        partial = _tag(AggregateRel(i, list(rel.group_keys), partial_specs), p)
        out = _finalize_agg(_shuffle(partial, key), rel, final_specs, avg_fixes)
        return _tag(out, Partitioning(HASH, key))

    def _ordered_tail(self, rel: Rel) -> Rel:
        """sort / fetch: global order — complete the input."""
        i = self.place(rel.input)
        out = dataclasses.replace(rel, input=self._to_complete(i))
        return _tag(out, Partitioning(COORD) if _part_of(i).kind != REP
                    else Partitioning(REP))

    _place_SortRel = _ordered_tail
    _place_FetchRel = _ordered_tail

    def _place_WindowRel(self, rel: WindowRel) -> Rel:
        i = self.place(rel.input)
        p = _part_of(i)
        if p.kind == HASH and p.key in rel.partition_keys:
            # window partitions are complete per shard
            return _tag(dataclasses.replace(rel, input=i), p)
        out = dataclasses.replace(rel, input=self._to_complete(i))
        return _tag(out, Partitioning(COORD) if p.kind != REP
                    else Partitioning(REP))

    def _place_SetRel(self, rel: SetRel) -> Rel:
        ops = [self.place(o) for o in rel.operands]
        parts = [_part_of(o) for o in ops]
        if all(p.kind == REP for p in parts):
            return _tag(dataclasses.replace(rel, operands=ops),
                        Partitioning(REP))
        if len(set(parts)) == 1 and parts[0].kind == HASH:
            return _tag(dataclasses.replace(rel, operands=ops), parts[0])
        ops = [self._to_complete(o) for o in ops]
        return _tag(dataclasses.replace(rel, operands=ops),
                    Partitioning(COORD))


def place_exchanges(plan: Rel, catalog, n_shards: int,
                    table_parts: Dict[str, Partitioning]) -> Rel:
    """Insert exchange boundaries; every returned node carries a
    ``dist_part`` tag and the root is coordinator-complete or replicated."""
    return ExchangePlacer(catalog, n_shards, table_parts).run(plan)


# ---------------------------------------------------------------------------
# fragment cutting
# ---------------------------------------------------------------------------


def cut_fragments(plan: Rel) -> List[ExchangeFragment]:
    """Cut a placed plan at every ``ExchangeRel`` into dependency-ordered
    fragments (root last) — the hybrid router's boundary-scan rewrite,
    with the exchange kind/keys recorded on the producing fragment."""
    fragments: List[ExchangeFragment] = []

    def make(root: Rel, kind: Optional[str], keys: List[str]) -> int:
        deps: List[int] = []

        def rewrite(node: Rel) -> Rel:
            if isinstance(node, ExchangeRel):
                fid = make(node.input, node.kind, node.keys)
                deps.append(fid)
                return ReadRel(boundary_name(fid))
            changes = {}
            field_names = [f.name for f in dataclasses.fields(node)]
            if isinstance(node, JoinRel):
                # build before probe: the committed build side can then
                # predicate-transfer into the probe's exchange
                field_names.remove("build")
                field_names.insert(0, "build")
            for fname in field_names:
                v = getattr(node, fname)
                if isinstance(v, Rel):
                    nv = rewrite(v)
                    if nv is not v:
                        changes[fname] = nv
                elif isinstance(v, list) and any(isinstance(x, Rel)
                                                 for x in v):
                    changes[fname] = [rewrite(x) if isinstance(x, Rel)
                                      else x for x in v]
            return dataclasses.replace(node, **changes) if changes else node

        new_root = rewrite(root)
        part = _part_of(root, default=Partitioning(COORD))
        is_root = kind is None
        placement = "coordinator" if is_root and part.kind in (COORD, REP) \
            else "shard"
        n_rels = sum(1 for r in walk_deep(new_root) if not is_dist_boundary(r))
        frag = ExchangeFragment(
            fid=len(fragments), plan=new_root, placement=placement,
            deps=deps, rel_count=n_rels, kind=kind, keys=list(keys),
            run_once=(part.kind == REP and not is_root))
        fragments.append(frag)
        return frag.fid

    make(plan, None, [])
    _mark_predicate_transfer(fragments)
    return fragments


def _mark_predicate_transfer(fragments: List[ExchangeFragment]) -> None:
    """Tag shuffle fragments that feed the probe of an inner/semi join
    whose build side is a registry table committed earlier: their rows may
    be pre-filtered by the build keys before the collective."""
    by_name = {boundary_name(f.fid): f for f in fragments}
    for consumer in fragments:
        for rel in walk_deep(consumer.plan):
            if not isinstance(rel, JoinRel) or rel.how not in ("inner", "semi"):
                continue
            if not (is_dist_boundary(rel.probe) and is_dist_boundary(rel.build)):
                continue
            pf = by_name.get(rel.probe.table)
            bf = by_name.get(rel.build.table)
            if pf is None or bf is None or bf.fid >= pf.fid:
                continue
            if pf.kind == "shuffle" and pf.pt is None:
                pf.pt = (bf.fid, rel.probe_keys[0], rel.build_keys[0])


def explain_placed(fragments: List[ExchangeFragment]) -> str:
    from ..core.plan import explain
    lines = []
    for f in fragments:
        head = f"fragment {f.fid}: out={f.kind or 'final'}"
        if f.keys:
            head += f" keys={f.keys}"
        head += f" placement={f.placement}"
        if f.run_once:
            head += " run_once"
        lines.append(head)
        lines.append(explain(f.plan, indent=1))
    return "\n".join(lines)
