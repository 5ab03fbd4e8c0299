"""The port's CUDA kernels and engine on the card (``gpu`` marker).

Every test here needs a CUDA device and skips without one; the decision is
made inside the fixture, never at import.  Each kernel is held against its
plain PyTorch version on the same inputs, and the engine's kernel path
against its generic path.  The file imports neither JAX nor ``repro``, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,c", [(1, 1), (2049, 3), (300_000, 4)])
def test_filter_mask_counts_on_card(dev, n, c):
    rng = np.random.default_rng(n + c)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, c)).astype(np.float32)).to(dev)
    lo = torch.tensor([-0.5] * c, device=dev)
    hi = torch.tensor([np.inf] + [0.5] * (c - 1), dtype=torch.float32, device=dev)
    mask, counts = ops.filter_mask_counts(x, lo, hi)
    want_mask, want_counts = ref.filter_mask_counts_ref(x, lo, hi)
    assert torch.equal(mask, want_mask)
    assert torch.equal(counts, want_counts)


@pytest.mark.parametrize("n,g,v", [(1, 1, 1), (5000, 7, 3), (200_000, 4096, 3),
                                   (300_000, 128, 15), (10_000, 3000, 5),
                                   (2_000_000, 1, 5)])
def test_groupby_sum_on_card(dev, n, g, v):
    """Within 1e-6 x sum|v| of the float64 sum of the same float32 inputs."""
    rng = np.random.default_rng(n + g + v)
    gids = torch.from_numpy(rng.integers(-1, g + 1, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(n, v)).astype(np.float32)).to(dev)
    got = ops.groupby_sum(gids, vals, g).double()
    ok = (gids >= 0) & (gids < g)
    safe = torch.where(ok, gids, 0).long()
    keep = vals.double() * ok[:, None]
    want = torch.zeros((g, v), dtype=torch.float64, device=dev).index_add_(0, safe, keep)
    scale = torch.zeros((g, v), dtype=torch.float64, device=dev).index_add_(
        0, safe, keep.abs())
    assert bool(((got - want).abs() <= 1e-6 * scale + 1e-30).all())


def test_groupby_sum_large_on_card(dev):
    rng = np.random.default_rng(9)
    g = 11_932                      # Q3's group count at SF1
    gids = torch.from_numpy(rng.integers(0, g, 31_617).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(31_617, 3)).astype(np.float32)).to(dev)
    got = ops.groupby_sum_large(gids, vals, 16_384)[:g].double()
    want = torch.zeros((g, 3), dtype=torch.float64, device=dev).index_add_(
        0, gids.long(), vals.double())
    scale = torch.zeros((g, 3), dtype=torch.float64, device=dev).index_add_(
        0, gids.long(), vals.double().abs())
    assert bool(((got - want).abs() <= 1e-6 * scale + 1e-30).all())


@pytest.mark.parametrize("n_build,n_probe", [(1, 5), (30_000, 800_000)])
def test_hash_probe_on_card(dev, n_build, n_probe):
    rng = np.random.default_rng(n_build)
    keys = torch.from_numpy(rng.choice(10 * n_build, n_build, replace=False)
                            .astype(np.int64)).to(dev)
    nb = ops.bucket_size(n_build)
    valid = torch.arange(nb, device=dev) < n_build
    s, _, ranks, _, _ = ops.sorted_build(ops.pad_rows(keys, nb), valid)
    sk, sr, placed = ops.build_table32(torch.where(valid, ranks, -1).to(torch.int32),
                                       valid)
    assert bool(placed)
    probe = torch.from_numpy(rng.integers(-5, 10 * n_build + 5, n_probe)).to(dev)
    p32 = ops.map_probe_keys(s, probe)
    row, found = ops.hash_probe(p32, sk, sr)
    want_row, want_found = ref.hash_probe_ref(p32, sk, sr)
    assert torch.equal(row, want_row) and torch.equal(found, want_found)
    assert torch.equal(found.cpu(), torch.isin(probe, keys).cpu())


@pytest.mark.parametrize("n_probe,n_build,key_range,how", [
    (10, 4, 3, "inner"), (50_000, 20_000, 30_000, "left"),
    (900_000, 2_000, 50_000, "inner")])
def test_join_expand_on_card(dev, n_probe, n_build, key_range, how):
    from repro_torch.relational.join import join_match
    rng = np.random.default_rng(n_probe)
    pk = torch.from_numpy(rng.integers(0, key_range, n_probe)).to(dev)
    bk = torch.from_numpy(rng.integers(0, key_range, n_build)).to(dev)
    order, lo, counts = join_match(pk, bk)
    counts_out = counts.clamp(min=1) if how == "left" else counts
    total = int(counts_out.sum())
    t_pad = ops.bucket_size(total)
    got = ops.join_expand(order, lo, counts, counts_out, t_pad)
    want = ref.join_expand_ref(order, lo, counts, counts_out, t_pad)
    for a, b in zip(got, want):
        assert torch.equal(a[:total], b[:total])


def test_wrappers_count_their_launches(dev):
    build.reset_launch_counts()
    x = torch.zeros((10, 1), device=dev)
    lo = torch.zeros(1, device=dev)
    ops.filter_mask_counts(x, lo, lo)
    ops.groupby_sum(torch.zeros(10, dtype=torch.int32, device=dev), x, 1)
    counts = build.launch_counts()
    assert counts["filter_mask_counts"] == 1 and counts["groupby_sum"] == 1


def test_wrappers_reject_wrong_dtypes_on_card(dev):
    x = torch.zeros((10, 1), dtype=torch.float64, device=dev)
    lo = torch.zeros(1, device=dev)
    with pytest.raises(ValueError):
        ops.filter_mask_counts(x, lo, lo)


@pytest.mark.parametrize("qid", [1, 3, 5, 6])
def test_engine_kernel_path_matches_generic_on_card(dev, qid):
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.data.tpch import generate, load_into_engine
    from repro_torch.data.tpch_queries import QUERIES
    db = generate(0.01)
    fast = SiriusEngine(use_kernels=True)
    plain = SiriusEngine(use_kernels=False)
    load_into_engine(fast, db)
    load_into_engine(plain, db)
    build.reset_launch_counts()
    got = fast.execute(QUERIES[qid]()).to_host()
    want = plain.execute(QUERIES[qid]()).to_host()
    assert sum(build.launch_counts().values()) > 0
    for k in want:
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
        else:
            assert (got[k] == want[k]).all(), k


@pytest.mark.parametrize("n,k,ties", [(433, 10, False), (1_048_573, 128, True),
                                      (1, 1, False), (1_025, 128, True),
                                      (300_000, 1, False)])
def test_topk_select_on_card(dev, n, k, ties):
    """Exact indices against the plain version (a stable sort)."""
    rng = np.random.default_rng(n + k)
    x = (rng.integers(0, 1000, n) if ties else rng.normal(size=n)).astype(np.float32)
    x[: min(n, 4)] = np.array([0.0, -0.0, 0.0, -0.0], np.float32)[: min(n, 4)]
    keys = torch.from_numpy(x).to(dev)
    got = ops.topk_select(keys, k)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, ref.topk_select_ref(keys, k))


def test_topk_select_rejects_what_it_does_not_take(dev):
    with pytest.raises(ValueError):
        ops.topk_select(torch.zeros(10, device=dev), 11)
    with pytest.raises(ValueError):
        ops.topk_select(torch.zeros(1000, device=dev), 129)
    with pytest.raises(ValueError):
        ops.topk_select(torch.zeros(10, dtype=torch.float64, device=dev), 1)


# ClickBench at 20,000 rows: kernel hits per query on the reference engine
CB_AGG = ("q0", "q1", "q2", "q6", "q12", "q14", "q20", "q21", "q43x", "q44x")
CB_TOPK = ("q8", "q12", "q14", "q21", "q22", "q44x")


@pytest.fixture(scope="module")
def clickbench_engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.data import clickbench as cb
    fast = SiriusEngine(use_kernels=True)
    cb.load_into_engine(fast, cb.generate(20_000))
    plain = SiriusEngine(use_kernels=False)
    plain.register("hits", fast.buffers.get("hits"))
    return fast, plain, cb.clickbench_catalog(20_000)


@pytest.mark.parametrize("qid", ["q0", "q1", "q2", "q4", "q5", "q6", "q8",
                                 "q10", "q12", "q14", "q20", "q21", "q22",
                                 "q43x", "q44x"])
def test_clickbench_kernel_path_matches_generic_on_card(clickbench_engines, qid):
    from repro_torch.core import instrument
    from repro_torch.data.clickbench import CLICKBENCH_QUERIES, CLICKBENCH_STRING_QIDS
    fast, plain, cat = clickbench_engines
    sql = CLICKBENCH_QUERIES[qid]
    before = fast.backend.hit_counts()
    build.reset_launch_counts()
    got = fast.sql(sql, catalog=cat).to_host()
    after = fast.backend.hit_counts()
    launched = build.launch_counts()
    hits = {k: after[k] - before[k] for k in after}
    assert hits == dict(filter=0, probe=0, agg=int(qid in CB_AGG), expand=0,
                        topk=int(qid in CB_TOPK))
    assert launched["topk_select"] == hits["topk"]
    assert launched["groupby_sum"] >= hits["agg"]
    want = plain.sql(sql, catalog=cat).to_host()
    assert set(got) == set(want)
    for k in want:
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
        else:
            assert (got[k] == want[k]).all(), k
    if qid in CLICKBENCH_STRING_QIDS:
        with instrument.track_transfers() as counter:
            fast.sql(sql, catalog=cat)
        assert counter.in_pipeline == 0
