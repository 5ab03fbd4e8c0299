"""The reference's default path on the port with the kernel backend: the
22 hand-built TPC-H plans through fused regions (kernel-mode probes) and
the executable-plan cache, on the CPU, where each kernel wrapper runs its
plain version (without kernels: ``test_torch_tpch_compiled.py``).

Both packages run their default engines (``compile_pipelines=True``) over
the same SF0.01 data, each query in order 1..22 on one engine.  Per query:
results equal the reference's (rtol 1e-6 for floats, row-exact
otherwise), cold and warm; kernel hits, region traces, region cache hits,
region calls, fused probes and eager ops equal the reference's.  Neither package
compiles a replay with a kernel backend attached: warm runs replay the
closure loop in both.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

from _torch_tpch_compiled import (
    QIDS, check_cold_run, check_warm_run, port_runs, reference_runs,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference(tpch_db):
    return reference_runs(tpch_db, use_kernels=True)


@pytest.fixture(scope="module")
def port(tpch_db):
    return port_runs(tpch_db, use_kernels=True)


@pytest.mark.parametrize("qid", QIDS)
def test_cold_run_matches_reference(qid, port, reference):
    check_cold_run(qid, port, reference)


@pytest.mark.parametrize("qid", QIDS)
def test_warm_run_replays_sync_free(qid, port, reference):
    check_warm_run(qid, port, reference)


def test_reference_compiles_no_replay_with_kernels(reference):
    assert not any(run[3] for run in reference.values())
