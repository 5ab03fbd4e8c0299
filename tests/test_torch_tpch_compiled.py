"""The reference's default path on the port without kernels: the 22
hand-built TPC-H plans through fused regions and the executable-plan cache,
on the CPU (with kernels: ``test_torch_tpch_compiled_kernels.py``; the SQL
texts: ``test_torch_tpch_sql.py``).

Both packages run their default engines (``compile_pipelines=True``) over
the same SF0.01 data, each query in order 1..22 on one engine.  Per query:
results equal the reference's (rtol 1e-6 for floats, row-exact
otherwise), cold and warm; kernel hits, region traces, region cache hits,
region calls, fused probes and eager ops equal the reference's.  The reference compiles a
replay for the queries ``chip_smoke.EXPECTED_GRAPH_QIDS`` names.  On the
CPU the port's replay walk at record time stands where the reference
traces its replay program, so the region cache hits count alike too.
"""
import sys
from pathlib import Path

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

from _torch_tpch_compiled import (
    QIDS, check_cold_run, check_warm_run, port_runs, reference_runs,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference(tpch_db):
    return reference_runs(tpch_db, use_kernels=False)


@pytest.fixture(scope="module")
def port(tpch_db):
    return port_runs(tpch_db, use_kernels=False)


@pytest.mark.parametrize("qid", QIDS)
def test_cold_run_matches_reference(qid, port, reference):
    check_cold_run(qid, port, reference)


@pytest.mark.parametrize("qid", QIDS)
def test_warm_run_replays_sync_free(qid, port, reference):
    check_warm_run(qid, port, reference)


def test_chip_smoke_graph_qids_are_the_references_compiled_replays(reference):
    """``chip_smoke.py`` expects a CUDA graph replay exactly where the
    reference compiles its warm replay into one program (no kernel
    backend), at SF0.01."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    compiled = {qid for qid, run in reference.items() if run[3]}
    assert chip_smoke.EXPECTED_GRAPH_QIDS == compiled
