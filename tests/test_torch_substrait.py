"""The port's Substrait front door against the reference's, on the CPU.

* Emission: the port's ``sql_to_wire`` of the 22 TPC-H and 15 ClickBench
  queries is byte-identical to ``tests/golden/substrait``, ingest
  round-trips to an equal plan and re-emission is byte-stable; the port's
  ``emit`` of the reference test's synthetic plans (the whole rel and
  expression vocabulary) is the reference's, byte for byte.
* Ingest: ``plan_to_json`` of the port's ingest of each golden file equals
  the reference's of the reference's ingest.
* Rejection: each malformed wire of ``tests/test_substrait.py`` raises
  ``SubstraitError`` with the reference's message; deleting any one key of
  a golden wire raises only ``SubstraitError`` (or ingests), as the
  reference does.
* Routing: fragment placements, deps, the device fraction and the
  ``explain_fragments`` text equal the reference router's.
* ``accelerate`` on the port's CPU engine: the reference ``accelerate``'s
  report (fragment counts, fraction, both boundary byte counts) and rows,
  on the four hybrid plans of ``tests/test_substrait.py`` and six golden
  TPC-H wires; the warm path (the wire bytes key) replays with one barrier
  and no scalar sync.

Floats are held at rtol 1e-6 (``conftest.assert_tables_equal``), every other
column row-exact.
"""
import copy
import json
import os

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

from repro.core.fallback import FallbackEngine as RefFallbackEngine
from repro.core.plan import plan_to_json as ref_plan_to_json
from repro.sql import sql_to_plan as ref_sql_to_plan
from repro.sql.binder import DEFAULT_CATALOG as REF_CATALOG
from repro import substrait as ref_substrait
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.core.fallback import FallbackEngine
from repro_torch.core.plan import (
    AggregateRel, ExchangeRel, FetchRel, FilterRel, JoinRel, ProjectRel,
    ReadRel, ScalarSubquery, SetRel, SortRel, WindowRel, plan_equal,
    plan_to_json,
)
from repro_torch.data.clickbench import (
    CLICKBENCH_QUERIES, clickbench_catalog,
)
from repro_torch.data.tpch import load_into_engine
from repro_torch.data.tpch_queries import SQL_QUERIES
from repro_torch.relational.aggregate import AggSpec
from repro_torch.relational.expressions import (
    Between, BinOp, Case, Cast, Col, DateLit, ExtractYear, InList, Like, Lit,
    StartsWith, Substr, UnOp,
)
from repro_torch.relational.sort import SortKey
from repro_torch.sql import run_sql, sql_to_plan, sql_to_wire
from repro_torch.sql.binder import DEFAULT_CATALOG
from repro_torch.substrait import (
    CapabilityRegistry, HybridRouter, SubstraitError, emit,
    explain_fragments, ingest, wire_bytes,
)

from conftest import assert_tables_equal

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "substrait")
GOLDEN = sorted(f[:-5] for f in os.listdir(GOLDEN_DIR) if f.endswith(".json"))


def _golden(name: str) -> bytes:
    with open(os.path.join(GOLDEN_DIR, f"{name}.json"), "rb") as f:
        return f.read()


def test_golden_set_is_the_37_queries():
    assert GOLDEN == sorted([f"tpch_q{q}" for q in SQL_QUERIES]
                            + [f"clickbench_{q}" for q in CLICKBENCH_QUERIES])


# ---------------------------------------------------------------------------
# emission: byte-identical to the golden files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qid", sorted(SQL_QUERIES))
def test_tpch_sql_to_wire_is_golden_and_round_trips(qid):
    wire = sql_to_wire(SQL_QUERIES[qid])
    blob = wire_bytes(wire)
    assert blob == _golden(f"tpch_q{qid}")
    restored = ingest(wire)
    assert plan_equal(restored, sql_to_plan(SQL_QUERIES[qid]))
    assert wire_bytes(emit(restored, DEFAULT_CATALOG)) == blob


@pytest.mark.parametrize("qid", sorted(CLICKBENCH_QUERIES))
def test_clickbench_sql_to_wire_is_golden_and_round_trips(qid):
    cat = clickbench_catalog()
    wire = sql_to_wire(CLICKBENCH_QUERIES[qid], cat)
    blob = wire_bytes(wire)
    assert blob == _golden(f"clickbench_{qid}")
    restored = ingest(wire)
    assert plan_equal(restored, sql_to_plan(CLICKBENCH_QUERIES[qid], cat))
    assert wire_bytes(emit(restored, cat)) == blob


@pytest.mark.parametrize("name", GOLDEN)
def test_ingest_of_golden_equals_reference_ingest(name):
    blob = _golden(name)
    assert plan_to_json(ingest(blob)) == \
        ref_plan_to_json(ref_substrait.ingest(blob))
    # JSON text and the parsed dict ingest alike
    assert plan_equal(ingest(blob.decode()), ingest(json.loads(blob)))


def _synthetic_plans(ns):
    """``tests/test_substrait.py``'s vocabulary plans, built from the
    classes in ``ns`` (the port's or the reference's)."""
    lineitem = ns.ReadRel("lineitem",
                          ["l_orderkey", "l_quantity", "l_comment"])
    orders = ns.ReadRel("orders", ["o_orderkey", "o_orderdate"],
                        filter=ns.Between(ns.Col("o_orderdate"),
                                          ns.DateLit("1994-01-01"),
                                          ns.DateLit("1994-12-31")))
    exprs = [
        ns.UnOp("not", ns.Like(ns.Col("l_comment"), "%special%requests%",
                               True)),
        ns.InList(ns.Col("l_orderkey"), [1, 2, 3], negate=True),
        ns.Case([(ns.Col("l_quantity") > 10, ns.Lit(1.5))], ns.Lit(0.0)),
        ns.Cast(ns.ExtractYear(ns.Col("o_orderdate")), "float64"),
        ns.Substr(ns.Col("l_comment"), 1, 3) == ns.Lit("abc"),
        ns.StartsWith(ns.Col("l_comment"), "fur"),
        ns.Col("l_quantity") * (ns.Lit(1) - ns.Col("l_quantity")
                                / ns.Lit(7.0)),
    ]
    plans = [ns.FilterRel(lineitem, e) for e in exprs[:2]]
    plans.append(ns.ProjectRel(lineitem, [("v", exprs[2])], keep_input=True))
    plans.append(ns.FilterRel(lineitem, exprs[4]))
    plans.append(ns.FilterRel(lineitem, exprs[5]))
    plans.append(ns.ProjectRel(orders, [("y", exprs[3])]))
    plans.append(ns.ProjectRel(lineitem, [("w", exprs[6])]))
    plans.append(ns.JoinRel(lineitem, orders, ["l_orderkey"], ["o_orderkey"],
                            how="mark", mark_name="__hit",
                            post_filter=ns.Col("l_quantity") > 5))
    plans.append(ns.AggregateRel(
        lineitem, ["l_orderkey"],
        [ns.AggSpec("sum", ns.Col("l_quantity"), "s"),
         ns.AggSpec("count_star", None, "n"),
         ns.AggSpec("count_distinct", ns.Col("l_comment"), "d")],
        having=ns.Col("s") > ns.Lit(10)))
    plans.append(ns.SortRel(ns.FetchRel(lineitem, 100),
                            [ns.SortKey("l_quantity", False),
                             ns.SortKey("l_orderkey", True)], limit=7))
    plans.append(ns.ExchangeRel(lineitem, "shuffle", ["l_orderkey"]))
    plans.append(ns.SetRel([lineitem, ns.ReadRel("lineitem")], "union_all"))
    plans.append(ns.WindowRel(lineitem, ["l_orderkey"],
                              [ns.SortKey("l_quantity", False)],
                              "row_number", None, "rn"))
    plans.append(ns.WindowRel(lineitem, [], [], "sum", "l_quantity", "tot"))
    plans.append(ns.FilterRel(
        lineitem,
        ns.Col("l_quantity") > ns.ScalarSubquery(
            ns.AggregateRel(ns.ReadRel("lineitem", ["l_quantity"]), [],
                            [ns.AggSpec("avg", ns.Col("l_quantity"), "a")]),
            "a")))
    return plans


class _Port:
    ReadRel, FilterRel, ProjectRel, JoinRel = ReadRel, FilterRel, ProjectRel, JoinRel
    AggregateRel, SortRel, FetchRel = AggregateRel, SortRel, FetchRel
    ExchangeRel, SetRel, WindowRel = ExchangeRel, SetRel, WindowRel
    ScalarSubquery, AggSpec, SortKey = ScalarSubquery, AggSpec, SortKey
    Between, BinOp, Case, Cast, Col, DateLit = Between, BinOp, Case, Cast, Col, DateLit
    ExtractYear, InList, Like, Lit = ExtractYear, InList, Like, Lit
    StartsWith, Substr, UnOp = StartsWith, Substr, UnOp


def _reference_ns():
    from repro.core import plan as p
    from repro.relational import aggregate, expressions as e, sort

    class _Ref:
        pass
    for name in dir(_Port):
        if not name.startswith("_"):
            for mod in (p, e, aggregate, sort):
                if hasattr(mod, name):
                    setattr(_Ref, name, getattr(mod, name))
                    break
    return _Ref


N_SYNTHETIC = len(_synthetic_plans(_Port))


@pytest.mark.parametrize("i", range(N_SYNTHETIC))
def test_synthetic_vocabulary_emits_the_reference_bytes(i):
    plan = _synthetic_plans(_Port)[i]
    blob = wire_bytes(emit(plan, DEFAULT_CATALOG))
    ref_plan = _synthetic_plans(_reference_ns())[i]
    assert blob == ref_substrait.wire_bytes(
        ref_substrait.emit(ref_plan, REF_CATALOG))
    restored = ingest(json.loads(blob.decode()))
    assert plan_equal(restored, plan)
    assert wire_bytes(emit(restored, DEFAULT_CATALOG)) == blob


# ---------------------------------------------------------------------------
# rejection: SubstraitError with the reference's message
# ---------------------------------------------------------------------------


def _q6_wire():
    return json.loads(_golden("tpch_q6"))


def _first(node, key):
    """The first dict under ``node`` that holds ``key`` (depth first)."""
    if isinstance(node, dict):
        if key in node:
            return node
        node = list(node.values())
    if isinstance(node, list):
        for v in node:
            r = _first(v, key)
            if r is not None:
                return r
    return None


def _unknown_rel(w):
    root = w["relations"][0]["root"]
    root["input"] = {"windowagg_v2": next(iter(root["input"].values()))}


def _window_wire(w):
    w.clear()
    w.update(json.loads(_golden("tpch_q6")))
    anchor = next(e["extensionFunction"]["functionAnchor"]
                  for e in w["extensions"]
                  if e["extensionFunction"]["name"] == "sum")
    w["relations"][0]["root"]["input"] = {
        "window": {"input": {"read": {"table": "lineitem"}},
                   "partitionKeys": [], "orderKeys": [],
                   "functionReference": anchor, "argument": None,
                   "name": "s"}}


def _count_star_window(w):
    _window_wire(w)
    w["extensions"].append({"extensionFunction": {
        "extensionUriReference": w["extensions"][-1]["extensionFunction"][
            "extensionUriReference"],
        "functionAnchor": 99, "name": "count_star"}})
    w["relations"][0]["root"]["input"]["window"]["functionReference"] = 99


def _empty_set(w):
    w["relations"][0]["root"]["input"] = {"set": {"inputs": [],
                                                  "op": "union_all"}}


def _bad_sort_direction(w):
    w["relations"][0]["root"]["input"] = {"sort": {
        "input": w["relations"][0]["root"]["input"],
        "sorts": [{"field": "revenue", "direction": "SIDEWAYS"}]}}


def _bad_join_type(w):
    read = {"read": {"table": "lineitem"}}
    w["relations"][0]["root"]["input"] = {"join": {
        "probe": read, "build": read, "probeKeys": [], "buildKeys": [],
        "type": "JOIN_TYPE_OUTER"}}


REJECTIONS = {
    "unknown_rel": _unknown_rel,
    "unregistered_function": lambda w: w["extensions"][0][
        "extensionFunction"].__setitem__("name", "frobnicate"),
    "undeclared_uri": lambda w: w["extensions"][0][
        "extensionFunction"].__setitem__("extensionUriReference", 404),
    "unknown_uri": lambda w: w["extensionUris"][0].__setitem__(
        "uri", "https://example.invalid/functions.yaml"),
    "dangling_reference": lambda w: _first(
        w["relations"], "functionReference").__setitem__(
        "functionReference", 9999),
    "missing_field": lambda w: _first(w["relations"], "read")["read"].pop(
        "table"),
    "major_version": lambda w: w["version"].__setitem__("majorNumber", 7),
    "window_without_argument": _window_wire,
    "count_star_window": _count_star_window,
    "empty_set": _empty_set,
    "bad_sort_direction": _bad_sort_direction,
    "bad_join_type": _bad_join_type,
    "wrong_typed_relation": lambda w: w["relations"].__setitem__(
        0, "not an object"),
    "wrong_typed_extension": lambda w: w["extensions"].__setitem__(
        0, "not an object"),
    "wrong_typed_uris": lambda w: w.__setitem__("extensionUris", "nope"),
    "no_version": lambda w: w.pop("version"),
    "no_relations": lambda w: w.__setitem__("relations", []),
}
GARBAGE = {"garbage_text": "this is not json {", "garbage_list": [1, 2, 3],
           "garbage_bytes": b"\x00\x01"}


def _rejection(ingest_fn, wire):
    with pytest.raises(Exception) as ei:
        ingest_fn(wire)
    return ei.value


@pytest.mark.parametrize("case", sorted(REJECTIONS) + sorted(GARBAGE))
def test_rejections_match_the_reference(case):
    if case in GARBAGE:
        wire = GARBAGE[case]
    else:
        wire = _q6_wire()
        REJECTIONS[case](wire)
    got = _rejection(ingest, copy.deepcopy(wire))
    want = _rejection(ref_substrait.ingest, copy.deepcopy(wire))
    assert isinstance(got, SubstraitError), repr(got)
    assert isinstance(want, ref_substrait.SubstraitError), repr(want)
    assert str(got) == str(want)


def test_rejection_messages_name_what_is_wrong():
    cases = {"unknown_rel": ("windowagg_v2", "read"),
             "unregistered_function": ("frobnicate", "registry"),
             "undeclared_uri": ("404",), "dangling_reference": ("9999",),
             "missing_field": ("table", "relations[0].root.input"),
             "major_version": ("major",),
             "window_without_argument": ("argument",),
             "count_star_window": ("count_star",),
             "empty_set": ("at least one input",)}
    for case, words in cases.items():
        wire = _q6_wire()
        REJECTIONS[case](wire)
        msg = str(_rejection(ingest, wire))
        for word in words:
            assert word in msg, (case, msg)


def _paths(node, prefix=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield prefix + (k,)
            yield from _paths(v, prefix + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _paths(v, prefix + (i,))


def _outcome(ingest_fn, to_json, wire):
    try:
        return "ok", to_json(ingest_fn(wire))
    except (SubstraitError, ref_substrait.SubstraitError) as e:
        return type(e).__name__, str(e)


def test_deleting_any_key_raises_only_substrait_error_as_the_reference():
    """Delete each key of the Q6 golden wire in turn: the port raises only
    ``SubstraitError`` (never a KeyError or TypeError), with the reference's
    message, and ingests exactly where the reference does."""
    base = _golden("tpch_q6")
    paths = list(_paths(json.loads(base)))
    assert len(paths) > 50
    for path in paths:
        wire = json.loads(base)
        node = wire
        for p in path[:-1]:
            node = node[p]
        del node[path[-1]]
        got = _outcome(ingest, plan_to_json, copy.deepcopy(wire))
        want = _outcome(ref_substrait.ingest, ref_plan_to_json, wire)
        assert got == want, ".".join(map(str, path))


# ---------------------------------------------------------------------------
# routing: placements, deps, fractions and explain text
# ---------------------------------------------------------------------------


def _window_plan(ns):
    return ns.FilterRel(
        ns.WindowRel(ns.ReadRel("lineitem", ["l_orderkey", "l_quantity"]),
                     ["l_orderkey"], [ns.SortKey("l_quantity", False)],
                     "row_number", None, "rn"),
        ns.BinOp("==", ns.Col("rn"), ns.Lit(1)))


def _union_plan(ns):
    half1 = ns.ReadRel("orders", ["o_orderkey", "o_totalprice"],
                       filter=ns.Col("o_orderkey") <= ns.Lit(1000))
    half2 = ns.ReadRel("orders", ["o_orderkey", "o_totalprice"],
                       filter=ns.Col("o_orderkey") > ns.Lit(1000))
    return ns.AggregateRel(ns.SetRel([half1, half2]), [],
                           [ns.AggSpec("count_star", None, "n"),
                            ns.AggSpec("sum", ns.Col("o_totalprice"), "s")])


def _host_rooted_plan(ns):
    return ns.WindowRel(ns.ReadRel("lineitem", ["l_orderkey", "l_quantity"]),
                        ["l_orderkey"], [], "sum", "l_quantity", "s")


def _q13_plan(ns):
    return (sql_to_plan if ns is _Port else ref_sql_to_plan)(SQL_QUERIES[13])


HYBRID = {"window": _window_plan, "union": _union_plan,
          "q13_without_like": _q13_plan, "host_rooted": _host_rooted_plan}


def _registries(case):
    if case == "q13_without_like":
        return (CapabilityRegistry(host_only_exprs=["Like"]),
                ref_substrait.CapabilityRegistry(host_only_exprs=["Like"]))
    return None, None


def _wires(case):
    port_plan = HYBRID[case](_Port)
    ref_plan = HYBRID[case](_reference_ns())
    return (wire_bytes(emit(port_plan, DEFAULT_CATALOG)),
            ref_substrait.wire_bytes(ref_substrait.emit(ref_plan,
                                                        REF_CATALOG)))


@pytest.mark.parametrize("case", sorted(HYBRID))
def test_fragments_equal_the_reference_router(case):
    reg, ref_reg = _registries(case)
    router = HybridRouter(None, reg)
    ref_router = ref_substrait.HybridRouter(None, ref_reg)
    frags = router.plan_fragments(HYBRID[case](_Port))
    ref_frags = ref_router.plan_fragments(HYBRID[case](_reference_ns()))
    assert [(f.fid, f.placement, f.deps, f.rel_count) for f in frags] == \
        [(f.fid, f.placement, f.deps, f.rel_count) for f in ref_frags]
    assert [plan_to_json(f.plan) for f in frags] == \
        [ref_plan_to_json(f.plan) for f in ref_frags]
    assert router.device_fragment_fraction(HYBRID[case](_Port)) == \
        ref_router.device_fragment_fraction(HYBRID[case](_reference_ns()))
    assert explain_fragments(frags) == \
        ref_substrait.explain_fragments(ref_frags)
    assert "[hybrid boundary]" in explain_fragments(frags)
    port_wire, ref_wire = _wires(case)
    assert port_wire == ref_wire


def test_window_plan_fragments_as_the_reference_test_pins():
    router = HybridRouter(None)
    frags = router.plan_fragments(_window_plan(_Port))
    assert [f.placement for f in frags] == ["device", "host", "device"]
    assert frags[1].deps == [0] and frags[2].deps == [1]
    assert router.device_fragment_fraction(_window_plan(_Port)) == \
        pytest.approx(2 / 3)
    txt = explain_fragments(frags)
    assert "Fragment 0 [device]" in txt
    assert "Fragment 1 [host] deps=[0]" in txt
    q6 = sql_to_plan(SQL_QUERIES[6])
    assert router.device_fragment_fraction(q6) == 1.0
    assert len(router.plan_fragments(q6)) == 1


# ---------------------------------------------------------------------------
# accelerate: the reference's reports and rows
# ---------------------------------------------------------------------------

REPORT_KEYS = ("device_fragments", "host_fragments", "device_rel_fraction",
               "boundary_to_host_bytes", "boundary_to_device_bytes")
GOLDEN_TPCH = (1, 4, 6, 12, 14, 19)


@pytest.fixture(scope="module")
def port_engine(tpch_db):
    eng = SiriusEngine(device="cpu")
    load_into_engine(eng, tpch_db)
    return eng


def _report(r):
    return ({k: r[k] for k in REPORT_KEYS},
            [(f["fid"], f["placement"], f["rels"], f["deps"])
             for f in r["fragments"]])


def _accelerate_both(port_engine, tpch_engine, port_wire, ref_wire, case):
    reg, ref_reg = _registries(case)
    bh = port_engine.buffers.boundary_to_host_bytes
    bd = port_engine.buffers.boundary_to_device_bytes
    got = port_engine.accelerate(port_wire, registry=reg)
    report = port_engine.last_accelerate_report
    assert port_engine.buffers.boundary_to_host_bytes - bh == \
        report["boundary_to_host_bytes"]
    assert port_engine.buffers.boundary_to_device_bytes - bd == \
        report["boundary_to_device_bytes"]
    assert got.device == port_engine.device
    want = tpch_engine.accelerate(ref_wire, registry=ref_reg)
    assert _report(report) == _report(tpch_engine.last_accelerate_report)
    assert_tables_equal(got.to_host(), want.to_host())
    return got, report


@pytest.mark.parametrize("case", sorted(HYBRID))
def test_accelerate_hybrid_plans_equal_the_reference(case, port_engine,
                                                     tpch_engine, tpch_db):
    port_wire, ref_wire = _wires(case)
    got, report = _accelerate_both(port_engine, tpch_engine, port_wire,
                                   ref_wire, case)
    assert report["host_fragments"] >= 1
    assert report["device_rel_fraction"] < 1.0
    if case == "q13_without_like":
        # the host fragment scans orders from the host copy: nothing
        # crosses to the host
        assert report["boundary_to_host_bytes"] == 0
        assert_tables_equal(got.to_host(), run_sql(SQL_QUERIES[13], tpch_db))
    else:
        assert report["boundary_to_host_bytes"] > 0
        assert report["boundary_to_device_bytes"] > 0
        want = FallbackEngine(tpch_db).execute(HYBRID[case](_Port))
        assert_tables_equal(got.to_host(), want)
    if case == "host_rooted":
        assert report["fragments"][-1]["placement"] == "host"


@pytest.mark.parametrize("qid", GOLDEN_TPCH)
def test_accelerate_golden_wire_equals_the_reference(qid, port_engine,
                                                     tpch_engine, tpch_db):
    blob = _golden(f"tpch_q{qid}")
    got, report = _accelerate_both(port_engine, tpch_engine, blob, blob,
                                   None)
    assert _report(report)[0] == {
        "device_fragments": 1, "host_fragments": 0,
        "device_rel_fraction": 1.0, "boundary_to_host_bytes": 0,
        "boundary_to_device_bytes": 0}
    assert_tables_equal(got.to_host(),
                        RefFallbackEngine(tpch_db).execute(
                            ref_substrait.ingest(blob)))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", [3, 13, 15, 21])
def test_warm_accelerate_replays_by_the_wire_bytes(qid, use_kernels, tpch_db,
                                                   monkeypatch):
    """A repeated wire skips ingest and routing: one barrier, no scalar
    sync, ``plan_cache_hit`` on the report; the result equals the cold
    run's and the SQL path's."""
    from repro_torch import substrait
    eng = SiriusEngine(device="cpu", use_kernels=use_kernels)
    load_into_engine(eng, tpch_db)
    blob = _golden(f"tpch_q{qid}")
    cold = eng.accelerate(blob).to_host()
    assert "plan_cache_hit" not in eng.last_accelerate_report
    ingests = []
    real = substrait.ingest
    monkeypatch.setattr(substrait, "ingest",
                        lambda *a: ingests.append(1) or real(*a))
    for wire in (blob, blob.decode(), json.loads(blob)):
        barriers = instrument.sync_barriers.value
        syncs = instrument.scalar_syncs.value
        warm = eng.accelerate(wire)
        assert instrument.sync_barriers.value - barriers == 1
        assert instrument.scalar_syncs.value == syncs
        assert eng.last_accelerate_report["plan_cache_hit"] is True
        assert eng.executor.last_plan_cache_hit
        assert_tables_equal(warm.to_host(), cold)
    assert ingests == []
    assert_tables_equal(cold, eng.sql(SQL_QUERIES[qid]).to_host())
    # a registry, or a register(), takes the cold path again
    eng.accelerate(blob, registry=CapabilityRegistry())
    assert ingests == [1]
    eng.register("region", eng.buffers.get("region"))
    assert eng._wire_plan_cache == {}
    eng.accelerate(blob)
    assert ingests == [1, 1]


def test_hybrid_wires_are_never_wire_cached(port_engine):
    port_wire, _ = _wires("window")
    port_engine.accelerate(port_wire)
    port_engine.accelerate(port_wire)
    assert "plan_cache_hit" not in port_engine.last_accelerate_report
    assert port_wire not in port_engine._wire_plan_cache
    # the temp tables are gone again
    assert not any(n.startswith("__substrait_frag")
                   for n in port_engine.buffers.stats()["cached_tables"])


def test_accelerate_analyze_waits_for_query_profile(port_engine):
    with pytest.raises(NotImplementedError, match="observability/profile.py"):
        port_engine.accelerate(_golden("tpch_q6"), analyze=True)
