"""The port's host fallback against the reference's, on the CPU.

* ``FallbackEngine`` (numpy, Python strings, ``datetime64`` dates) is
  row-exact against the reference's on the 22 TPC-H queries at SF0.01 over
  the same host dicts, from the SQL texts (``run_sql`` on a host dict) and
  from the hand-built plans; floats at rtol 1e-6, the columns' dtypes equal.
* ``np_window``: the reference test's semantics cases, and every window
  function against the reference's on random data.
* ``SiriusEngine.execute_with_fallback``: a plan the engine cannot lower
  (``WindowRel``) runs on the host and is counted; an error raised by a
  kernel wrapper propagates instead (ROADMAP queue 3: the reference
  degrades on any exception).
* Two repairs against the reference: ``explain`` marks hybrid boundary
  scans as the reference does, and the TPC-H and ClickBench loaders keep
  the host dicts with the engine (``SiriusEngine.host_tables``).
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.core import fallback as ref_fallback
from repro.core.plan import ReadRel as RefReadRel
from repro.core.plan import explain as ref_explain
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro.relational.sort import SortKey as RefSortKey
from repro.sql import run_sql as ref_run_sql
from repro_torch.core import fallback
from repro_torch.core.executor import PlanNotLowerable, SiriusEngine
from repro_torch.core.fallback import FallbackEngine
from repro_torch.core.plan import (
    HYBRID_BOUNDARY_PREFIX, AggregateRel, FilterRel, ReadRel, SetRel,
    WindowRel, explain,
)
from repro_torch.data.tpch import load_into_engine
from repro_torch.data.tpch_queries import QUERIES, SQL_QUERIES
from repro_torch.relational.aggregate import AggSpec
from repro_torch.relational.expressions import BinOp, Col, Lit
from repro_torch.relational.sort import SortKey
from repro_torch.relational.table import Table
from repro_torch.sql import run_sql

from conftest import assert_tables_equal

torch.set_num_threads(1)

QIDS = sorted(SQL_QUERIES)


def _same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
    assert_tables_equal(got, want)


@pytest.mark.parametrize("qid", QIDS)
def test_run_sql_on_host_dict_matches_reference(qid, tpch_db):
    _same(run_sql(SQL_QUERIES[qid], tpch_db),
          ref_run_sql(SQL_QUERIES[qid], tpch_db))


@pytest.mark.parametrize("qid", QIDS)
def test_fallback_engine_on_hand_built_plans_matches_reference(qid, tpch_db):
    _same(FallbackEngine(tpch_db).execute(QUERIES[qid]()),
          ref_fallback.FallbackEngine(tpch_db).execute(REF_QUERIES[qid]()))


def test_window_oracle_semantics():
    """The reference test's cases: row_number, partition sum, global avg."""
    db = {"t": {"g": np.array([1, 1, 2, 2, 2]),
                "v": np.array([3.0, 1.0, 5.0, 4.0, 6.0])}}
    fb = FallbackEngine(db)
    rn = fb.execute(WindowRel(ReadRel("t"), ["g"],
                              [SortKey("v", True)], "row_number", None, "rn"))
    assert list(rn["rn"]) == [2, 1, 2, 1, 3]
    tot = fb.execute(WindowRel(ReadRel("t"), ["g"], [], "sum", "v", "s"))
    assert list(tot["s"]) == [4.0, 4.0, 15.0, 15.0, 15.0]
    avg = fb.execute(WindowRel(ReadRel("t"), [], [], "avg", "v", "a"))
    np.testing.assert_allclose(avg["a"], np.full(5, 19.0 / 5))


WINDOWS = [("row_number", None, True), ("rank", None, True),
           ("rank", None, False), ("count", None, True), ("sum", "v", True),
           ("sum", "i", True), ("avg", "v", True), ("min", "v", True),
           ("max", "i", True)]


@pytest.mark.parametrize("partitioned", [True, False])
@pytest.mark.parametrize("func,arg,ascending", WINDOWS)
def test_np_window_matches_reference(func, arg, ascending, partitioned):
    rng = np.random.default_rng(7)
    n = 500
    t = {"g": rng.integers(0, 9, n),
         "s": np.array(["x", "yy", "z"])[rng.integers(0, 3, n)],
         "v": np.round(rng.normal(size=n), 1),
         "i": rng.integers(-5, 5, n),
         "d": np.datetime64("1995-01-01") + rng.integers(0, 30, n)}
    parts = ["g", "s"] if partitioned else []
    got = fallback.np_window(t, parts, [SortKey("i", ascending),
                                        SortKey("d", True)], func, arg, "w")
    want = ref_fallback.np_window(t, parts, [RefSortKey("i", ascending),
                                             RefSortKey("d", True)],
                                  func, arg, "w")
    assert got["w"].dtype == want["w"].dtype
    np.testing.assert_array_equal(got["w"], want["w"])


def test_setrel_union_all_runs_on_the_host(tpch_db):
    half = ReadRel("orders", ["o_orderkey"], filter=Col("o_orderkey") <= Lit(100))
    out = FallbackEngine(tpch_db).execute(SetRel([half, half]))
    keys = tpch_db["orders"]["o_orderkey"]
    assert len(out["o_orderkey"]) == 2 * int((keys <= 100).sum())
    with pytest.raises(ValueError):
        FallbackEngine(tpch_db).execute(SetRel([half], "intersect"))


# ---------------------------------------------------------------------------
# execute_with_fallback
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kernel_engine(tpch_db):
    eng = SiriusEngine(device="cpu", use_kernels=True)
    load_into_engine(eng, tpch_db)
    return eng


def _window_plan():
    return FilterRel(
        WindowRel(ReadRel("lineitem", ["l_orderkey", "l_quantity"]),
                  ["l_orderkey"], [SortKey("l_quantity", False)],
                  "row_number", None, "rn"),
        BinOp("==", Col("rn"), Lit(1)))


def test_execute_with_fallback_routes_an_unlowerable_plan_to_the_host(
        kernel_engine, tpch_db):
    with pytest.raises(TypeError):            # the reference's contract
        kernel_engine.execute(_window_plan())
    n0 = kernel_engine.executor.fallback_queries
    out, route = kernel_engine.execute_with_fallback(_window_plan())
    assert route == "fallback"
    assert kernel_engine.executor.fallback_queries == n0 + 1
    assert_tables_equal(out, FallbackEngine(tpch_db).execute(_window_plan()))
    got, route = kernel_engine.execute_with_fallback(QUERIES[6]())
    assert route == "accelerator"
    assert kernel_engine.executor.fallback_queries == n0 + 1
    assert_tables_equal(got.to_host(),
                        FallbackEngine(tpch_db).execute(QUERIES[6]()))


@pytest.mark.parametrize("wrapper,qid", [("groupby_sum", 1),
                                         ("hash_probe", 3)])
def test_execute_with_fallback_reraises_kernel_errors(kernel_engine, wrapper,
                                                      qid, monkeypatch):
    """A kernel launch error is never hidden behind the host path."""
    from repro_torch.kernels import ops

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(ops, wrapper, broken)
    kernel_engine.executor.plan_cache.clear()
    n0 = kernel_engine.executor.fallback_queries
    with pytest.raises(RuntimeError, match="illegal memory access"):
        kernel_engine.execute_with_fallback(QUERIES[qid]())
    assert kernel_engine.executor.fallback_queries == n0


def test_plan_not_lowerable_is_a_type_error():
    assert issubclass(PlanNotLowerable, TypeError)
    eng = SiriusEngine(device="cpu")
    host = {"a": np.arange(3)}
    eng.register("t", Table.from_pydict(host), host)
    with pytest.raises(PlanNotLowerable, match="WindowRel"):
        eng.execute(WindowRel(ReadRel("t"), [], [], "count", None, "n"))


# ---------------------------------------------------------------------------
# repairs
# ---------------------------------------------------------------------------


def test_explain_marks_hybrid_boundary_scans_as_the_reference():
    assert HYBRID_BOUNDARY_PREFIX == "__substrait_frag"
    port = AggregateRel(ReadRel("__substrait_frag0", ["a"]), [],
                        [AggSpec("count_star", None, "n")])
    from repro.core.plan import AggregateRel as RefAggregateRel
    from repro.relational.aggregate import AggSpec as RefAggSpec
    ref = RefAggregateRel(RefReadRel("__substrait_frag0", ["a"]), [],
                          [RefAggSpec("count_star", None, "n")])
    assert explain(port) == ref_explain(ref)
    assert "__substrait_frag0  [hybrid boundary] cols=['a']" in explain(port)
    assert explain(ReadRel("lineitem")) == ref_explain(RefReadRel("lineitem"))


def test_loaders_keep_the_host_dicts(tpch_db):
    from repro_torch.data import clickbench
    eng = SiriusEngine(device="cpu")
    load_into_engine(eng, tpch_db)
    assert set(eng.host_tables) == set(tpch_db)
    assert all(eng.host_tables[n] is tpch_db[n] for n in tpch_db)
    cb = clickbench.generate(1000, seed=3)
    clickbench.load_into_engine(eng, cb)
    assert eng.host_tables["hits"] is cb["hits"]
    # a re-register without host data keeps the host copy
    eng.register("region", eng.buffers.get("region"))
    assert eng.host_tables["region"] is tpch_db["region"]
