"""The 22 TPC-H SQL texts through the port's ``SiriusEngine.sql`` on its
default path, on the CPU, with and without kernels.

Each text runs twice on one engine: the first call parses, optimizes and
records; the second must come through the normalized-text front door (no
parse, a plan-cache replay, no scalar sync).  Both results are held against
the numpy oracle ``FallbackEngine`` running the reference's hand-built plan
(rtol 1e-6 for floats, row-exact otherwise), which the reference's own
tests hold its engine to.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

from repro.core.fallback import FallbackEngine
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro_torch import sql as port_sql
from repro_torch.core import instrument
from repro_torch.core.executor import SiriusEngine
from repro_torch.data.tpch import load_into_engine
from repro_torch.data.tpch_queries import SQL_QUERIES

from conftest import assert_tables_equal

torch.set_num_threads(1)

QIDS = sorted(SQL_QUERIES)


@pytest.fixture(scope="module")
def oracle(tpch_db):
    return {qid: FallbackEngine(tpch_db).execute(REF_QUERIES[qid]())
            for qid in QIDS}


@pytest.fixture(scope="module")
def engines(tpch_db):
    out = {}
    for uk in (False, True):
        eng = SiriusEngine(device="cpu", use_kernels=uk)
        load_into_engine(eng, tpch_db)
        out[uk] = eng
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", QIDS)
def test_sql_text_matches_reference_cold_and_warm(qid, use_kernels, engines,
                                                  oracle, monkeypatch):
    eng = engines[use_kernels]
    parses = []
    run_sql = port_sql.run_sql

    def counting(*args, **kwargs):
        parses.append(1)
        return run_sql(*args, **kwargs)

    monkeypatch.setattr(port_sql, "run_sql", counting)
    assert_tables_equal(eng.sql(SQL_QUERIES[qid]).to_host(), oracle[qid])
    assert parses == [1] and not eng.executor.last_plan_cache_hit
    syncs = instrument.scalar_syncs.value
    barriers = instrument.sync_barriers.value
    assert_tables_equal(eng.sql(SQL_QUERIES[qid]).to_host(), oracle[qid])
    assert parses == [1], "the second call parsed the text again"
    assert eng.executor.last_plan_cache_hit
    assert instrument.scalar_syncs.value == syncs
    assert instrument.sync_barriers.value - barriers == 1
