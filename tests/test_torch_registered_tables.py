"""ClickBench's ``hits`` at its official size on the kernel engine, on the
CPU at small sizes: ``SiriusEngine.sql(text)`` binds a registered table
its default catalog lacks (and keeps the TPC-H plans as they were), the
group-by kernel route takes any row count in chunks with exact counts,
and ``COUNT(DISTINCT)`` runs in its own journal span."""
import numpy as np
import pytest
import torch

from repro_torch.core import kernel_backend
from repro_torch.core.executor import SiriusEngine
from repro_torch.core.plan import explain
from repro_torch.data import clickbench, tpch
from repro_torch.data.tpch_queries import SQL_QUERIES
from repro_torch.kernels import ops
from repro_torch.observability.journal import JOURNAL
from repro_torch.observability.metrics import METRICS
from repro_torch.relational.aggregate import AggSpec, group_aggregate
from repro_torch.relational.expressions import Col
from repro_torch.relational.table import Column, Table
from repro_torch.sql import sql_to_plan, sql_to_wire
from repro_torch.sql.binder import DEFAULT_CATALOG
from repro_torch.substrait import wire_bytes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hits_engine():
    eng = SiriusEngine(device="cpu", use_kernels=True)
    clickbench.load_into_engine(eng, clickbench.generate(5_000, seed=3))
    return eng


@pytest.mark.parametrize("qid", sorted(clickbench.CLICKBENCH_QUERIES))
def test_a_registered_table_binds_through_sql_text(hits_engine, qid):
    """No catalog: the same rows as with the ClickBench catalog, and the
    second run is a plan-cache replay."""
    text = clickbench.CLICKBENCH_QUERIES[qid]
    first = hits_engine.sql(text).to_host()
    assert not hits_engine.executor.last_plan_cache_hit
    second = hits_engine.sql(text).to_host()
    assert hits_engine.executor.last_plan_cache_hit
    want = hits_engine.sql(text, catalog=clickbench.clickbench_catalog(5_000))
    for got in (first, second):
        assert list(got) == list(want.to_host())
        for k, v in want.to_host().items():
            np.testing.assert_array_equal(got[k], v)


def test_a_registered_table_is_bound_by_its_columns_and_rows(hits_engine):
    cat = DEFAULT_CATALOG.with_tables(hits_engine.table_schemas,
                                      hits_engine.table_rows)
    assert cat.columns("hits") == list(hits_engine.table_schemas["hits"])
    assert cat.kind("hits", "url") == "string"
    assert cat.kind("hits", "eventdate") == "date"
    assert cat.row_estimate("hits") == 5_000.0
    assert cat.row_estimate("lineitem") == DEFAULT_CATALOG.row_estimate("lineitem")
    assert DEFAULT_CATALOG.with_tables({}, {}) is DEFAULT_CATALOG
    assert not DEFAULT_CATALOG.has_table("hits")


@pytest.fixture(scope="module")
def tpch_engine():
    eng = SiriusEngine(device="cpu", use_kernels=True)
    tpch.load_into_engine(eng, tpch.generate(0.002))
    # a table of another schema beside them
    eng.register("hits", Table({"userid": Column(torch.arange(3))}))
    return eng


def _catalog_of_sql(eng, text, monkeypatch):
    """The catalog ``eng.sql(text)`` plans with."""
    import repro_torch.sql as sql
    seen = {}
    real = sql.run_sql

    def spy(text, db, catalog=None, optimize=True):
        seen["catalog"] = catalog
        return real(text, db, catalog=catalog, optimize=optimize)
    monkeypatch.setattr(sql, "run_sql", spy)
    eng.sql(text)
    return seen["catalog"]


@pytest.mark.parametrize("qid", sorted(SQL_QUERIES))
def test_tpch_plans_stay_byte_identical(tpch_engine, qid, monkeypatch):
    """With the TPC-H tables (and another) registered, each query is
    planned from the default catalog's schema and statistics, as before:
    the same plan and the same wire bytes."""
    text = SQL_QUERIES[qid]
    cat = _catalog_of_sql(tpch_engine, text, monkeypatch)
    before = DEFAULT_CATALOG.with_dictionaries(tpch_engine.table_dictionaries)
    for t in tpch.TPCH_SCHEMA:
        assert cat.schema[t] is before.schema[t]
        assert cat.row_estimate(t) == before.row_estimate(t)
    assert explain(sql_to_plan(text, catalog=cat)) == \
        explain(sql_to_plan(text, catalog=before))
    assert wire_bytes(sql_to_wire(text, catalog=cat)) == \
        wire_bytes(sql_to_wire(text, catalog=before))


def _table(n, groups, seed):
    rng = np.random.default_rng(seed)
    return Table({"k": Column(torch.from_numpy(rng.integers(0, groups, n))),
                  "j": Column(torch.from_numpy(rng.integers(0, 3, n))),
                  "v": Column(torch.from_numpy(rng.integers(-50, 2000, n))),
                  "f": Column(torch.from_numpy(rng.normal(1e3, 50.0, n)))})


AGGS = [AggSpec("count_star", None, "c"), AggSpec("count", Col("v"), "cv"),
        AggSpec("sum", Col("v"), "s"), AggSpec("avg", Col("f"), "a"),
        AggSpec("sum", Col("f"), "sf"), AggSpec("min", Col("v"), "lo"),
        AggSpec("max", Col("f"), "hi")]


@pytest.mark.parametrize("n,groups,keys", [(1_000, 7, ["k"]), (1_025, 300, ["k", "j"]),
                                           (4_097, 2_000, ["k"]), (700, 1, [])])
def test_chunked_group_by_equals_the_generic_path(n, groups, keys, monkeypatch):
    """Past ROW_BOUND rows (lowered here to 256) the kernel route runs on
    chunks: the generic group_aggregate's groups, int64 counts exact,
    integer sums and extremes exact; float sums and averages within the
    float32 rounding of each chunk's centred sums."""
    monkeypatch.setattr(kernel_backend, "ROW_BOUND", 256)
    t = _table(n, groups, n)
    chunks = METRICS.counter("kernel.groupby_row_chunks")
    before = chunks.value
    got = kernel_backend.KernelBackend().try_aggregate(t, keys, AGGS).to_host()
    assert chunks.value - before == -(-n // 256)
    want = group_aggregate(t, keys, AGGS).to_host()
    assert list(got) == list(want)
    for c in keys + ["c", "cv", "s", "lo", "hi"]:
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c])
    assert got["c"].sum() == n
    for c in ("a", "sf"):
        np.testing.assert_allclose(got[c], want[c], rtol=1e-8)


def test_one_launch_up_to_the_row_bound(monkeypatch):
    """At ROW_BOUND rows or fewer a group-by is one launch, and counts no
    chunk."""
    monkeypatch.setattr(kernel_backend, "ROW_BOUND", 256)
    calls = []
    real = ops.groupby_sum_large
    monkeypatch.setattr(kernel_backend.kops, "groupby_sum_large",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    chunks = METRICS.counter("kernel.groupby_row_chunks")
    before = chunks.value
    kernel_backend.KernelBackend().try_aggregate(_table(256, 5, 1), ["k"], AGGS)
    assert calls == [256] and chunks.value == before
    kernel_backend.KernelBackend().try_aggregate(_table(600, 5, 1), ["k"], AGGS)
    assert calls[1:] == [256, 256, 88] and chunks.value - before == 3


def test_integer_sums_past_float32s_integers_are_exact(monkeypatch):
    """A large group far from the column's centre: its centred sum
    (18,380,919) is past 2^24, where float32 outputs stop holding
    integers, so the route sums again about each group's own mean; sums
    and averages equal the generic path's exactly, with or without
    chunks."""
    n0, n1 = 20_001, 20_000
    t = Table({"k": Column(torch.cat([torch.zeros(n0, dtype=torch.int64),
                                      torch.ones(n1, dtype=torch.int64)])),
               "v": Column(torch.cat([torch.full((n0,), 1839),
                                      torch.zeros(n1, dtype=torch.int64)]))})
    aggs = [AggSpec("sum", Col("v"), "s"), AggSpec("avg", Col("v"), "a")]
    want = group_aggregate(t, ["k"], aggs).to_host()
    assert want["s"][0] == 1839 * n0
    for bound in (kernel_backend.ROW_BOUND, 4_096):
        monkeypatch.setattr(kernel_backend, "ROW_BOUND", bound)
        got = kernel_backend.KernelBackend().try_aggregate(t, ["k"], aggs).to_host()
        np.testing.assert_array_equal(got["s"], want["s"])
        np.testing.assert_array_equal(got["a"], want["a"])


def test_count_distinct_runs_in_its_span_under_the_group_by(hits_engine):
    JOURNAL.clear()
    hits_engine.sql(clickbench.CLICKBENCH_QUERIES["q8"])
    spans = [e for e in JOURNAL.events() if e["kind"] == "span"]
    by_id = {s["span_id"]: s for s in spans}
    inner = [s for s in spans if s["name"] == "agg.count_distinct"]
    assert inner
    for s in inner:
        assert by_id[s["parent_id"]]["name"] == "sink.groupby"
    JOURNAL.clear()
    hits_engine.sql(clickbench.CLICKBENCH_QUERIES["q12"])
    assert not any(e["name"] == "agg.count_distinct" for e in JOURNAL.events())


def test_topk_bytes_count_each_key_once_and_each_index(hits_engine):
    moved = METRICS.counter("kernel.topk_bytes")
    before = moved.value
    ops.topk_select(torch.arange(1_000, dtype=torch.int64), 10)
    ops.topk_select(torch.arange(300, dtype=torch.float32), 7)
    assert moved.value - before == 1_000 * 8 + 10 * 4 + 300 * 4 + 7 * 4
