"""The 22 TPC-H queries on the port, against the JAX package, on the CPU.

The port's engine runs with ``device="cpu"`` (each kernel wrapper then runs
its plain version), with and without the kernel backend, on the default
(compiled, plan-cached) path and on the eager ``compile_pipelines=False``
path.  Its results are held against the reference engine
(``use_kernels=True``, ``compile_pipelines=False``) and against the numpy
oracle ``FallbackEngine`` with the suite's tolerance (rtol 1e-6, other
columns row-exact); the eager path's kernel hit counts against the
reference's eager path, but for the group-bys with a count distinct,
which only the port's kernel backend takes (``tests/test_torch_tpch_compiled.py`` holds the
default path's against the reference's default path).
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.core.executor import SiriusEngine as RefEngine
from repro.core.fallback import FallbackEngine
from repro.core.plan import explain as ref_explain
from repro.data.tpch import generate as ref_generate
from repro.data.tpch import load_into_engine as ref_load
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro_torch.core import executor as texec
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.core.plan import explain
from repro_torch.data.tpch import generate, load_into_engine
from repro_torch.data.tpch_queries import QUERIES

from conftest import assert_tables_equal

# the suite runs files in parallel worker processes: keep torch to one
# thread so the workers do not oversubscribe the cores
torch.set_num_threads(1)

QIDS = sorted(QUERIES)


def _hits(filter=0, probe=0, agg=0, expand=0, topk=0) -> dict:
    return dict(filter=filter, probe=probe, agg=agg, expand=expand, topk=topk)


# kernel hits per query at SF0.01 on the reference engine's eager path
# (use_kernels=True, compile_pipelines=False)
EXPECTED_HITS = {
    1: _hits(filter=1, agg=1), 2: _hits(probe=7, agg=1),
    3: _hits(filter=2, probe=2, agg=1), 4: _hits(filter=1, agg=1),
    5: _hits(filter=1, probe=4, agg=1, expand=1), 6: _hits(filter=1, agg=1),
    7: _hits(filter=1, probe=5, agg=1), 8: _hits(filter=1, probe=7, agg=1),
    9: _hits(probe=4, agg=1, expand=1), 10: _hits(filter=1, probe=3),
    11: _hits(probe=4, agg=2), 12: _hits(probe=1, agg=1),
    13: _hits(agg=2, expand=1), 14: _hits(filter=1, probe=1, agg=1),
    15: _hits(filter=3, probe=1, agg=3), 16: _hits(probe=2),
    17: _hits(probe=2, agg=2), 18: _hits(probe=3, agg=1), 19: _hits(probe=1),
    20: _hits(filter=1, probe=2, agg=1, expand=1), 21: _hits(probe=5, agg=1),
    22: _hits(filter=1, agg=2),
}
# the port's departure: its kernel backend also takes the group-bys with a
# count distinct (Q16's, Q21's two subqueries'), which the reference's
# declines
DISTINCT_GROUPBYS = {16: 1, 21: 2}
PORT_HITS = {q: {**h, "agg": h["agg"] + DISTINCT_GROUPBYS.get(q, 0)}
             for q, h in EXPECTED_HITS.items()}


@pytest.fixture(scope="module")
def db():
    return ref_generate(scale_factor=0.01, seed=19920101)


@pytest.fixture(scope="module")
def reference(db):
    """Per query: the reference engine's result and its kernel hits."""
    eng = RefEngine(use_kernels=True, compile_pipelines=False)
    ref_load(eng, db)
    out = {}
    for qid in QIDS:
        before = eng.backend.hit_counts()
        res = eng.execute(REF_QUERIES[qid]()).to_host()
        after = eng.backend.hit_counts()
        out[qid] = (res, {k: after[k] - before[k] for k in after})
    return out


@pytest.fixture(scope="module")
def oracle(db):
    return {qid: FallbackEngine(db).execute(REF_QUERIES[qid]()) for qid in QIDS}


def _engine(db, **kw):
    eng = SiriusEngine(device="cpu", **kw)
    load_into_engine(eng, db)
    return eng


@pytest.fixture(scope="module")
def engines(db):
    return {(uk, cp): _engine(db, use_kernels=uk, compile_pipelines=cp)
            for uk in (False, True) for cp in (False, True)}


def test_generate_gives_identical_arrays(db):
    mine = generate(0.01, seed=19920101)
    assert list(mine) == list(db)
    for table in db:
        assert list(mine[table]) == list(db[table])
        for col, want in db[table].items():
            got = mine[table][col]
            assert got.dtype == want.dtype, (table, col)
            np.testing.assert_array_equal(got, want, err_msg=f"{table}.{col}")


def _check_query(eng, qid, reference, oracle):
    for _ in range(2):     # cold, then warm
        got = eng.execute(QUERIES[qid]()).to_host()
        assert_tables_equal(got, reference[qid][0])
        assert_tables_equal(got, oracle[qid])


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", QIDS)
def test_query_matches_reference_and_oracle(qid, use_kernels, engines,
                                            reference, oracle):
    """The default path, cold and then warm (a plan-cache replay)."""
    eng = engines[use_kernels, True]
    _check_query(eng, qid, reference, oracle)
    assert eng.executor.last_plan_cache_hit


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", QIDS)
def test_eager_path_matches_reference_and_oracle(qid, use_kernels, engines,
                                                 reference, oracle):
    eng = engines[use_kernels, False]
    _check_query(eng, qid, reference, oracle)
    assert not eng.executor.last_plan_cache_hit


@pytest.mark.parametrize("qid", QIDS)
def test_kernel_hits_match_reference(qid, db, reference):
    """The eager path's hits against the reference's eager path."""
    eng = _engine(db, use_kernels=True, compile_pipelines=False)
    eng.execute(QUERIES[qid]())
    assert reference[qid][1] == EXPECTED_HITS[qid]
    assert eng.backend.hit_counts() == PORT_HITS[qid]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", [1, 6])
def test_small_morsels_do_not_change_results(qid, use_kernels, db, oracle):
    eng = _engine(db, use_kernels=use_kernels, morsel_rows=1000)
    assert_tables_equal(eng.execute(QUERIES[qid]()).to_host(), oracle[qid])


@pytest.mark.parametrize("qid", [1, 3])
def test_profile_mode_times_operators_and_matches(qid, db, oracle):
    eng = _engine(db, use_kernels=True, profile=True)
    assert_tables_equal(eng.execute(QUERIES[qid]()).to_host(), oracle[qid])
    times = eng.executor.op_times
    assert times["filter"] > 0 and times["groupby"] > 0
    if qid == 3:
        assert times["join"] > 0


def _waits_once(eng, qid):
    eng.execute(QUERIES[qid]())
    before = instrument.sync_barriers.value
    syncs = instrument.scalar_syncs.value
    eng.execute(QUERIES[qid]())
    assert eng.executor.last_plan_cache_hit
    assert instrument.sync_barriers.value - before == 1
    assert instrument.scalar_syncs.value == syncs


@pytest.mark.parametrize("qid", QIDS)
def test_default_path_waits_once_per_query(qid, engines):
    """A warm run of the default path waits once (its final barrier) and
    pulls no scalar; a cold run of a query with scalar subqueries waits
    once more for each subquery, whose value becomes a literal."""
    _waits_once(engines[True, True], qid)


@pytest.mark.parametrize("qid", QIDS)
def test_default_path_waits_once_per_query_without_kernels(qid, engines):
    _waits_once(engines[False, True], qid)


@pytest.mark.parametrize("qid", QIDS)
def test_explain_matches_reference(qid):
    assert explain(QUERIES[qid]()) == ref_explain(REF_QUERIES[qid]())


def test_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SiriusEngine()
    with pytest.raises(RuntimeError):
        texec.default_device()


def test_topk_route_raises_where_the_reference_launches_its_kernel(engines):
    """Where the reference launches ``topk_select`` the port now launches
    its own (the plain version on CPU tensors) and counts a hit; outside
    the kernel's contract it declines, as the reference does."""
    from repro_torch.relational.sort import SortKey, sort_table
    from repro_torch.relational.table import Table
    backend = engines[True, True].backend
    t = Table.from_pydict({"a": np.arange(500, dtype=np.int64),
                           "f": np.linspace(0, 1, 500)})
    before = backend.topk_hits
    got = backend.try_topk(t, [SortKey("a", False)], 10)
    assert backend.topk_hits == before + 1
    assert_tables_equal(got.to_host(),
                        sort_table(t, [SortKey("a", False)], 10).to_host())
    assert backend.try_topk(t, [SortKey("f")], 10) is None
    assert backend.try_topk(t, [SortKey("a")], None) is None
    assert backend.try_topk(t, [SortKey("a")], 500) is None
