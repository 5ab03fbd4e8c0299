"""The top-k selection of the port against the JAX package, on the CPU.

``topk_select_ref`` (the plain version the CUDA kernel is held against on
the card, and what the wrapper runs for CPU tensors) must give exactly the
indices of the Pallas ``topk_select`` in interpret mode and of a stable
numpy argsort.  ``KernelBackend.try_topk`` must pick the same rows as the
reference backend's and route or decline at the same 2^24 edge.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernel_backend import KernelBackend as RefBackend
from repro.kernels.topk import topk_select as pallas_topk
from repro.relational.sort import SortKey as RefSortKey
from repro.relational.table import Table as RefTable
from repro_torch.core.kernel_backend import KernelBackend
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_select_ref
from repro_torch.kernels.topk import scratch_len
from repro_torch.relational.sort import SortKey, sort_table
from repro_torch.relational.table import Table

from conftest import assert_tables_equal

torch.set_num_threads(1)


def _keys(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ties":            # a handful of distinct integer values
        return rng.integers(0, 7, n).astype(np.float32)
    if kind == "zeros":           # -0.0 beside +0.0, with negatives and ties
        x = rng.choice(np.array([-0.0, 0.0, -1.5, 2.0], np.float32), n)
        return x.astype(np.float32)
    if kind == "descending":      # try_topk's packing of a descending count
        counts = rng.integers(0, 1000, n)
        return ((counts.max() - counts) * 1000 + rng.integers(0, 1000, n)) \
            .astype(np.float32)
    return rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("kind", ["ties", "zeros", "descending", "normal"])
@pytest.mark.parametrize("n,k", [(1_025, 1), (1_025, 128), (3_000, 10),
                                 (3_000, 128), (433, 10), (433, 1)])
def test_ref_matches_pallas_and_stable_argsort(kind, n, k):
    x = _keys(kind, n, seed=n * 131 + k)
    got = topk_select_ref(torch.from_numpy(x), k)
    assert got.dtype == torch.int32 and got.shape == (k,)
    want = np.asarray(pallas_topk(jnp.asarray(x), k, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(x, kind="stable")[:k])


def test_negative_zero_ties_with_positive_zero():
    x = np.array([0.0, -0.0, 0.0, -0.0, -1.0], np.float32)
    got = topk_select_ref(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, [4, 0, 1, 2])
    np.testing.assert_array_equal(
        got, np.asarray(pallas_topk(jnp.asarray(x), 4, interpret=True)))


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    x = torch.from_numpy(_keys("ties", 2_000, 3))
    assert torch.equal(ops.topk_select(x, 10), topk_select_ref(x, 10))


@pytest.mark.parametrize("n,k,want", [
    (433, 10, 0),                       # one tile: no scratch
    (1_024, 128, 0),
    (1_025, 10, 2 * 10),                # 2 tiles → 20 candidates → done
    (1_048_573, 128, 1_024 * 128 + 128 * 128),
])
def test_scratch_holds_the_first_two_rounds(n, k, want):
    assert scratch_len(n, k) == want


def _tables(cols: dict):
    return Table.from_pydict(cols), RefTable.from_pydict(cols)


def _both_topk(cols: dict, keys, limit):
    """→ (port result, reference result, port hit, reference hit)."""
    mine, theirs = KernelBackend(), RefBackend(interpret=True)
    t, rt = _tables(cols)
    got = mine.try_topk(t, [SortKey(n, a) for n, a in keys], limit)
    want = theirs.try_topk(rt, [RefSortKey(n, a) for n, a in keys], limit)
    return got, want, mine.topk_hits, theirs.topk_hits


@pytest.mark.parametrize("keys", [
    [("c", False), ("s", True)],            # q12's shape: count desc, code
    [("s", True)],
    [("c", True), ("s", False)],
    [("e", True), ("c", False), ("s", True)],
])
def test_try_topk_picks_the_reference_rows(keys):
    rng = np.random.default_rng(len(keys))
    n = 433
    cols = {"c": rng.integers(1, 300, n).astype(np.int64),
            "s": np.array([f"w{i:03d}" for i in rng.permutation(n)]),
            "e": rng.integers(0, 4, n).astype(np.int64),
            "f": rng.normal(size=n)}
    got, want, hit, ref_hit = _both_topk(cols, keys, 10)
    assert hit == ref_hit == 1
    assert_tables_equal(got.to_host(), want.to_host())
    t = Table.from_pydict(cols)
    generic = sort_table(t, [SortKey(nm, a) for nm, a in keys], 10)
    assert_tables_equal(got.to_host(), generic.to_host())


@pytest.mark.parametrize("spans,routes", [
    ((2**24,), True), ((2**24 + 1,), False),
    ((4_096, 4_096), True), ((4_096, 4_097), False),
])
def test_try_topk_routes_and_declines_at_the_f32_edge(spans, routes):
    rng = np.random.default_rng(sum(spans))
    n = 300
    cols = {}
    for i, span in enumerate(spans):
        v = rng.integers(0, span, n).astype(np.int64)
        v[0], v[1] = 0, span - 1          # pin the span exactly
        cols[f"k{i}"] = v
    keys = [(f"k{i}", i % 2 == 0) for i in range(len(spans))]
    got, want, hit, ref_hit = _both_topk(cols, keys, 7)
    assert hit == ref_hit == int(routes)
    if routes:
        assert_tables_equal(got.to_host(), want.to_host())
    else:
        assert got is None and want is None


def test_try_topk_declines_outside_the_contract():
    cols = {"a": np.arange(500, dtype=np.int64), "f": np.linspace(0, 1, 500)}
    for keys, limit in ([[("f", True)], 10], [[("a", True)], None],
                        [[("a", True)], 500], [[("a", True)], 129]):
        got, want, hit, ref_hit = _both_topk(cols, keys, limit)
        assert got is None and want is None and hit == ref_hit == 0
