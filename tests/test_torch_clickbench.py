"""ClickBench through ``SiriusEngine.sql`` on the port, against the JAX package.

At 20,000 rows (seed 20130701) the port's generator gives the reference's
arrays, and the port's engine (``device="cpu"``, where every kernel wrapper
runs its plain version) answers all 15 queries as the reference engine
(``use_kernels=True``, ``compile_pipelines=False``) does, with the suite's
tolerance, and with the same kernel hits per query but one departure: a
group-by with a count distinct runs on the port's kernel backend
(``count_distinct``), where the reference's backend declines it.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.core.executor import SiriusEngine as RefEngine
from repro.data import clickbench as ref_cb
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.data import clickbench as cb

from conftest import assert_tables_equal

torch.set_num_threads(1)

N_ROWS = 20_000
SEED = 20130701
QIDS = list(cb.CLICKBENCH_QUERIES)
# kernel hits per query at 20,000 rows on the reference engine
AGG_QIDS = ("q0", "q1", "q2", "q6", "q12", "q14", "q20", "q21", "q43x", "q44x")
TOPK_QIDS = ("q8", "q12", "q14", "q21", "q22", "q44x")
EXPECTED_HITS = {q: dict(filter=0, probe=0, agg=int(q in AGG_QIDS), expand=0,
                         topk=int(q in TOPK_QIDS)) for q in QIDS}
# the port's: the group-bys with a count distinct take the kernel backend too
DISTINCT_QIDS = ("q4", "q5", "q8", "q10", "q22")
PORT_HITS = {q: {**h, "agg": h["agg"] + int(q in DISTINCT_QIDS)}
             for q, h in EXPECTED_HITS.items()}


@pytest.fixture(scope="module")
def db():
    return ref_cb.generate(N_ROWS, seed=SEED)


@pytest.fixture(scope="module")
def catalog():
    return cb.clickbench_catalog(N_ROWS)


@pytest.fixture(scope="module")
def reference(db):
    """Per query: the reference engine's result and its kernel hits."""
    eng = RefEngine(use_kernels=True, compile_pipelines=False)
    ref_cb.load_into_engine(eng, db)
    cat = ref_cb.clickbench_catalog(N_ROWS)
    out = {}
    for qid in QIDS:
        before = eng.backend.hit_counts()
        res = eng.sql(cb.CLICKBENCH_QUERIES[qid], catalog=cat).to_host()
        after = eng.backend.hit_counts()
        out[qid] = (res, {k: after[k] - before[k] for k in after})
    return out


@pytest.fixture(scope="module")
def engines(db):
    out = {}
    for use_kernels in (False, True):
        eng = SiriusEngine(device="cpu", use_kernels=use_kernels)
        cb.load_into_engine(eng, db)
        out[use_kernels] = eng
    return out


def test_generate_gives_identical_arrays(db):
    mine = cb.generate(N_ROWS, seed=SEED)
    assert list(mine["hits"]) == list(db["hits"]) == list(cb.CLICKBENCH_SCHEMA["hits"])
    for col, want in db["hits"].items():
        got = mine["hits"][col]
        assert got.dtype == want.dtype, col
        np.testing.assert_array_equal(got, want, err_msg=col)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", QIDS)
def test_query_matches_reference(qid, use_kernels, engines, catalog, reference):
    got = engines[use_kernels].sql(cb.CLICKBENCH_QUERIES[qid],
                                   catalog=catalog).to_host()
    assert_tables_equal(got, reference[qid][0])


@pytest.mark.parametrize("qid", QIDS)
def test_kernel_hits_match_reference(qid, engines, catalog, reference):
    backend = engines[True].backend
    before = backend.hit_counts()
    engines[True].sql(cb.CLICKBENCH_QUERIES[qid], catalog=catalog)
    after = backend.hit_counts()
    hits = {k: after[k] - before[k] for k in after}
    assert reference[qid][1] == EXPECTED_HITS[qid]
    assert hits == PORT_HITS[qid]


@pytest.mark.parametrize("qid", cb.CLICKBENCH_STRING_QIDS)
def test_string_queries_copy_nothing_to_the_host_in_pipelines(qid, engines,
                                                              catalog):
    """The copies a card run would make, counted on the CPU run: none inside
    pipeline execution (the reference's device-residency contract)."""
    eng = engines[True]
    sql = cb.CLICKBENCH_QUERIES[qid]
    eng.sql(sql, catalog=catalog)
    with instrument.track_transfers("cpu") as counter:
        eng.sql(sql, catalog=catalog)
    assert counter.in_pipeline == 0


def test_transfer_tracking_counts_and_restores():
    x = torch.arange(4)
    with instrument.track_transfers("cpu") as counter:
        x.tolist()
        instrument.pull_scalar(x[0])      # a counted scalar sync, not a copy
        with instrument.pipeline_scope():
            x.cpu()
            x.to("cpu")
            x.to(torch.float64)           # no device change
            int(x[1])
    assert (counter.total, counter.in_pipeline) == (4, 3)
    with instrument.track_transfers() as counter:   # CUDA tensors only
        x.cpu()
    assert counter.total == 0
    assert "__int__" not in vars(torch.Tensor) and "cpu" not in vars(torch.Tensor)


def test_sql_waits_once_per_query(engines, catalog):
    before = instrument.sync_barriers.value
    engines[True].sql(cb.CLICKBENCH_QUERIES["q21"], catalog=catalog)
    assert instrument.sync_barriers.value - before == 1


def test_register_keeps_dictionaries_and_drops_stale_ones(db):
    from repro_torch.relational.table import Table
    eng = SiriusEngine(device="cpu")
    cb.load_into_engine(eng, db)
    assert set(eng.table_dictionaries["hits"]) == {
        c for c, k in cb.CLICKBENCH_SCHEMA["hits"].items() if k == "string"}
    eng.register("hits", Table.from_pydict({"x": np.arange(3)}))
    assert "hits" not in eng.table_dictionaries
