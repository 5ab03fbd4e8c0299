"""The port's CUDA kernels and engine on the card (``gpu`` marker).

Every test here needs a CUDA device and skips without one; the decision is
made inside the fixture, never at import.  Each kernel is held against its
plain PyTorch version on the same inputs, and the engine's kernel path
against its generic path.  The file imports neither JAX nor ``repro``, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from pathlib import Path

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


def _ranked_table(dev, build_keys):
    """try_probe's build of int64 ``build_keys``: sorted_build's ranks into
    build_table32 → (sorted keys, slots_key, slots_row)."""
    n = len(build_keys)
    nb = ops.bucket_size(n)
    valid = torch.arange(nb, device=dev) < n
    s, _, ranks, _, _ = ops.sorted_build(
        ops.pad_rows(torch.from_numpy(build_keys).to(dev), nb), valid)
    sk, sr, placed = ops.build_table32(
        torch.where(valid, ranks, -1).to(torch.int32), valid)
    assert bool(placed)
    return s, sk, sr


def _colliding_keys(mask, count):
    """``2 * count`` int32 keys whose first slot under ``mask`` is slot 3."""
    cand = torch.arange(0, 2_000_000, dtype=torch.int32)
    return cand[ref.hash32(cand, mask) == 3][:2 * count].numpy()


def _probe_inputs(kind, n_build, n_probe, arg, dev):
    """One case's int32 probe keys, table, max_probes, and the (probe,
    build) keys whose np.isin the flags must equal (None where chains are
    cut short)."""
    rng = np.random.default_rng(n_build + n_probe + arg)
    if kind == "negative keys":   # raw int32 keys, the build's own
        keys = np.unique(np.concatenate([
            rng.integers(-2**31, 0, n_build), [-1, -2, -2**31]])).astype(np.int32)
        probe = np.where(rng.random(n_probe) < 0.5, rng.choice(keys, n_probe),
                         rng.integers(-2**31, 0, n_probe)).astype(np.int32)
        sk, sr, placed = ops.build_table32(torch.from_numpy(keys).to(dev))
        assert bool(placed)
        return torch.from_numpy(probe).to(dev), sk, sr, 32, (probe, keys)
    if kind == "long chains":     # 2 * n_build keys on one chain's slot
        collide = _colliding_keys(ops.bucket_size(2 * n_build) - 1, n_build)
        keys = collide[:n_build]  # a chain of n_build slots from slot 3
        sk, sr, placed = ops.build_table32(torch.from_numpy(keys).to(dev),
                                           max_probes=2 * n_build)
        assert bool(placed)
        probe = np.concatenate([collide, rng.integers(0, 2**31 - 1, n_probe)]
                               ).astype(np.int32)
        return torch.from_numpy(probe).to(dev), sk, sr, arg, None
    keys = rng.choice(10 * n_build, n_build, replace=False).astype(np.int64)
    s, sk, sr = _ranked_table(dev, keys)
    if kind == "all absent":      # ranks past the build: varied slots
        probe = rng.integers(n_build, 2**31 - 1, n_probe).astype(np.int32)
        return torch.from_numpy(probe).to(dev), sk, sr, 32, (probe, np.arange(n_build))
    if kind == "all hits":
        probe = rng.choice(keys, n_probe)
    elif kind == "hot key":       # one build key for 99.5% of the keys
        probe = np.where(rng.random(n_probe) < 0.995, keys[7],
                         rng.integers(-5, 10 * n_build + 5, n_probe))
    else:                         # ~10% hits; "offset": a view at arg
        probe = rng.integers(-5, 10 * n_build + 5, n_probe + arg)
    p32 = ops.map_probe_keys(s, torch.from_numpy(probe).to(dev))
    if kind == "offset":
        p32, probe = p32[arg:], probe[arg:]
        assert p32.data_ptr() % 16 != 0
    return p32, sk, sr, 32, (probe, keys)


@pytest.mark.parametrize("kind,n_build,n_probe,arg", [
    ("uniform", 1, 5, 0), ("uniform", 30_000, 800_000, 0),
    *[("uniform", 5_000, n, 0) for n in (1, 7, 8, 9, 1023, 1025, 2**20 + 3)],
    ("offset", 5_000, 70_001, 1), ("offset", 5_000, 70_001, 3),
    ("all hits", 150_000, 300_000, 0), ("all absent", 150_000, 300_000, 0),
    ("hot key", 150_000, 500_000, 0), ("negative keys", 20_000, 200_000, 0),
    ("long chains", 40, 1_000, 1), ("long chains", 40, 1_000, 2),
    ("long chains", 40, 1_000, 32)])
def test_hash_probe_on_card(dev, kind, n_build, n_probe, arg):
    """Exactly the plain version: ragged lengths, key views that do not
    start on 16 bytes, all hits, all absent, one hot key, negative keys,
    and chains cut by max_probes."""
    p32, sk, sr, max_probes, isin = _probe_inputs(kind, n_build, n_probe, arg, dev)
    row, found = ops.hash_probe(p32, sk, sr, max_probes)
    want_row, want_found = ref.hash_probe_ref(p32, sk, sr, max_probes)
    assert torch.equal(row, want_row) and torch.equal(found, want_found)
    if isin is not None:
        assert np.array_equal(found.cpu().numpy(), np.isin(*isin))
    else:   # the chain of n_build keys is longer than max_probes
        assert int(found.sum()) == min(max_probes, n_build)


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
    for a, b in zip(got, want):     # the whole bucket, filler included
        assert torch.equal(a, b)


def _groupby_want(gids, vals, g):
    """The float64 sums of the rows in range, and sum|v| per cell."""
    ok = (gids >= 0) & (gids < g)
    safe = torch.where(ok, gids, 0).long()
    keep = vals.double() * ok[:, None]
    zeros = torch.zeros((g, vals.shape[1]), dtype=torch.float64, device=vals.device)
    return zeros.index_add(0, safe, keep), zeros.index_add(0, safe, keep.abs())


def _check_groupby(dev, n, g, v, seed, gid_range=None, gids=None):
    """groupby_sum against the float64 sums of the same float32 inputs:
    column 0 (ones) exactly, the others within 1e-6 x sum|v|; one launch,
    counted as one-pass above 4096 groups; the stream's accumulator zero
    after it."""
    from repro_torch.kernels import groupby_agg
    from repro_torch.observability.metrics import METRICS
    rng = np.random.default_rng(seed)
    if gids is None:
        lo, hi = gid_range or (-1, g + 1)
        gids = rng.integers(lo, hi, n).astype(np.int32)
    gids = torch.from_numpy(gids).to(dev)
    vals = rng.normal(size=(n, v)).astype(np.float32)
    vals[:, 0] = 1.0
    vals = torch.from_numpy(vals).to(dev)
    wide = METRICS.counter("kernel.groupby_wide").value
    build.reset_launch_counts()
    got = ops.groupby_sum(gids, vals, g)
    assert build.launch_counts()["groupby_sum"] == 1
    assert METRICS.counter("kernel.groupby_wide").value == wide + (g > 4096)
    want, scale = _groupby_want(gids, vals, g)
    assert torch.equal(got[:, 0].double(), want[:, 0])
    assert bool(((got.double() - want).abs() <= 1e-6 * scale + 1e-30).all())
    stream = torch.cuda.current_stream(dev).cuda_stream
    acc, tickets = groupby_agg._workspaces[(dev.index or 0, stream)]
    assert not bool(acc.any()) and not bool(tickets.any())
    return got


@pytest.mark.parametrize("n,g,v,live", [
    (2_000_000, 262_144, 3, 200_000),   # Q13's call at SF10, scaled down
    (1_000_000, 100_003, 3, 100_003),   # G not a power of two
    (500_000, 20_000, 15, 20_000),      # Q1's width
    (300_000, 8_192, 40, 8_192),        # V = 40: two warps' worth of columns
    (300_000, 4_097, 1, 4_097)])        # the first G of the one-pass design
def test_groupby_sum_one_pass_on_card(dev, n, g, v, live):
    """G above 4096: one pass over the rows into the device-memory
    accumulator; gids uniform over [-1, live], so -1 (and G where live = G)
    are dropped."""
    _check_groupby(dev, n, g, v, seed=g + v, gid_range=(-1, live + 1))


def test_groupby_sum_one_pass_drops_out_of_range_gids_on_card(dev):
    """Gids far outside [0, G), on both sides, beside gids in range."""
    rng = np.random.default_rng(3)
    n, g = 400_000, 50_000
    gids = rng.integers(0, g, n).astype(np.int32)
    bad = rng.random(n) < 0.3
    gids[bad] = rng.choice(np.int32([-2 ** 31, -7, g, g + 1, 2 ** 31 - 1]), int(bad.sum()))
    _check_groupby(dev, n, g, 3, seed=4, gids=gids)


@pytest.mark.parametrize("order", ["shuffled", "sorted"])
def test_groupby_sum_one_pass_hot_group_on_card(dev, order):
    """One group holds 30% of the rows: its rows of a warp sum in
    registers before one atomic; sorted gids put whole warps on a group."""
    rng = np.random.default_rng(5)
    n, g = 1_000_000, 65_536
    gids = np.where(rng.random(n) < 0.3, 777, rng.integers(0, g, n)).astype(np.int32)
    if order == "sorted":
        gids.sort()
    _check_groupby(dev, n, g, 3, seed=6, gids=gids)


def test_groupby_sum_one_pass_twice_on_one_stream_on_card(dev):
    """Two one-pass launches in a row on one stream, the second over fewer
    groups and columns than the accumulator holds: each right, and the
    accumulator zero after each."""
    first = _check_groupby(dev, 600_000, 131_072, 3, seed=8)
    second = _check_groupby(dev, 300_000, 5_000, 2, seed=9)
    assert first.shape == (131_072, 3) and second.shape == (5_000, 2)


@pytest.mark.parametrize("g", [12, 128, 4096])
def test_groupby_sum_register_and_shared_groups_on_card(dev, g):
    """Gids uniform over [-1, G]: the first 8 groups add in registers, the
    rest in shared memory, -1 and G are dropped."""
    _check_groupby(dev, 300_000, g, 3, seed=g)


@pytest.mark.parametrize("v", [1, 16, 17, 33, 300])
def test_groupby_sum_column_edges_on_card(dev, v):
    """V = 16 is the widest two-rows-a-warp chunk, 17 the narrowest full
    warp, 33 two column chunks, 300 tiles narrower than a warp's step;
    gids over both paths."""
    _check_groupby(dev, 200_003, 128, v, seed=v, gid_range=(-1, 20))


@pytest.mark.parametrize("n", [1, 2, 12_345, 1_000_001])
def test_groupby_sum_ragged_row_counts_on_card(dev, n):
    """N = 1, and N not a multiple of a block's slice or a warp's step."""
    _check_groupby(dev, n, 128, 5, seed=n, gid_range=(0, 10))


@pytest.mark.parametrize("v", [3, 15])
def test_groupby_sum_unaligned_inputs_on_card(dev, v):
    """gids and values that do not start on a 16-byte boundary (views one
    row in) take 4-byte copies into the ring."""
    rng = np.random.default_rng(v)
    n = 100_001
    gids = torch.from_numpy(rng.integers(-1, 40, n + 1).astype(np.int32)).to(dev)[1:]
    vals = torch.from_numpy(rng.normal(size=(n + 1, v)).astype(np.float32)).to(dev)[1:]
    assert gids.data_ptr() % 16 and vals.data_ptr() % 16
    got = ops.groupby_sum(gids, vals, 128)
    want, scale = _groupby_want(gids, vals, 128)
    assert bool(((got.double() - want).abs() <= 1e-6 * scale + 1e-30).all())


@pytest.mark.parametrize("g", [1, 128, 4096])
def test_groupby_sum_every_gid_dropped_on_card(dev, g):
    n = 50_000
    gids = torch.full((n,), -1, dtype=torch.int32, device=dev)
    gids[::2] = g
    vals = torch.ones((n, 4), device=dev)
    got = ops.groupby_sum(gids, vals, g)
    assert torch.equal(got, torch.zeros_like(got))


def test_groupby_sum_on_two_streams_in_turn_on_card(dev):
    """Each stream keeps its own float64 accumulator and ticket counters,
    which every launch leaves at zero: calls that alternate between two
    streams stay right, and the scratch is zero after them."""
    from repro_torch.kernels import groupby_agg
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    rng = np.random.default_rng(21)
    cases = []
    for i in range(6):
        g = (128, 4096, 20)[i % 3]
        gids = torch.from_numpy(rng.integers(-1, g + 1, 100_000).astype(np.int32)).to(dev)
        vals = torch.from_numpy(rng.normal(size=(100_000, 1 + i)).astype(np.float32)).to(dev)
        cases.append((gids, vals, g))
    outs = []
    for i, (gids, vals, g) in enumerate(cases):
        streams[i % 2].wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(streams[i % 2]):
            outs.append(ops.groupby_sum(gids, vals, g))
    torch.cuda.synchronize(dev)
    for (gids, vals, g), got in zip(cases, outs):
        want, scale = _groupby_want(gids, vals, g)
        assert bool(((got.double() - want).abs() <= 1e-6 * scale + 1e-30).all())
    for st in streams:
        acc, tickets = groupby_agg._workspaces[(dev.index or 0, st.cuda_stream)]
        assert not bool(acc.any()) and not bool(tickets.any())


def _check_expand(order, lo, counts, counts_out, total):
    """join_expand against the plain version over the whole bucket, in one
    launch."""
    build.reset_launch_counts()
    got = ops.join_expand(order, lo, counts, counts_out, total)
    assert build.launch_counts()["join_expand"] == int(total > 0)
    want = ref.join_expand_ref(order, lo, counts, counts_out, total)
    for a, b in zip(got, want):
        assert a.shape == (total,) and torch.equal(a, b)


def test_join_expand_one_long_run_on_card(dev):
    """Skew: one run of 300,000 among 999,999 empty runs is written by one
    block, in chunks; the filler after it belongs to the last (empty) run."""
    n, long_run = 1_000_000, 300_000
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    counts[654_321] = long_run
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    order = torch.from_numpy(np.random.default_rng(1).permutation(long_run)).to(dev)
    _check_expand(order, lo, counts, counts, ops.bucket_size(long_run))


@pytest.mark.parametrize("at", [0, 2047, 2048, 399_999])
def test_join_expand_long_run_placed_anywhere_on_card(dev, at):
    """A run of 100,000 at a tile's first or last run, or the last run
    (its outputs run into the filler); tiles past 8,192 outputs leave the
    rest to the helper blocks."""
    n, long_run = 400_000, 100_000
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    counts[at] = long_run
    counts[1::1000] += 1
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    order = torch.from_numpy(np.random.default_rng(at).permutation(long_run)).to(dev)
    _check_expand(order, lo, counts, counts, ops.bucket_size(int(counts.sum())))


def test_join_expand_many_to_many_on_card(dev):
    """Every tile has far more than 8,192 outputs (runs of 0-39): the
    helpers write most of the output, tile by tile."""
    rng = np.random.default_rng(4)
    n, nb = 60_000, 50_000
    counts = torch.from_numpy(rng.integers(0, 40, n)).to(dev)
    lo = torch.from_numpy(rng.integers(0, nb - 39, n)).to(dev)
    order = torch.from_numpy(rng.permutation(nb)).to(dev)
    _check_expand(order, lo, counts, counts, ops.bucket_size(int(counts.sum())))


@pytest.mark.parametrize("n", [1, 2048, 2049, 100_000])
def test_join_expand_every_count_zero_on_card(dev, n):
    """Total 0: the whole bucket of 8 is filler of the last run."""
    z = torch.zeros(n, dtype=torch.int64, device=dev)
    order = torch.arange(5, device=dev)
    _check_expand(order, z + 3, z, z, ops.bucket_size(0))


@pytest.mark.parametrize("n_probe,key_range", [(5_000, 3_000), (2_000_000, 4_000_000)])
def test_join_expand_left_join_on_card(dev, n_probe, key_range):
    """counts_out = max(counts, 1): unmatched rows emit one unmatched output."""
    from repro_torch.relational.join import join_match
    rng = np.random.default_rng(n_probe)
    pk = torch.from_numpy(rng.integers(0, key_range, n_probe)).to(dev)
    bk = torch.from_numpy(rng.integers(0, key_range, 100_000)).to(dev)
    order, lo, counts = join_match(pk, bk)
    counts_out = counts.clamp(min=1)
    _check_expand(order, lo, counts, counts_out,
                  ops.bucket_size(int(counts_out.sum())))


@pytest.mark.parametrize("cut", [1, 1000, 2 ** 15])
def test_join_expand_bucket_shorter_than_total_on_card(dev, cut):
    """A bucket shorter than the true total cuts the output there."""
    from repro_torch.relational.join import join_match
    rng = np.random.default_rng(cut)
    pk = torch.from_numpy(rng.integers(0, 1000, 400_000)).to(dev)
    bk = torch.from_numpy(rng.integers(0, 1000, 3_000)).to(dev)
    order, lo, counts = join_match(pk, bk)
    assert int(counts.sum()) > cut
    _check_expand(order, lo, counts, counts, cut)


def test_join_expand_many_calls_on_two_streams_on_card(dev):
    """The status words and tile counter are reused, never zeroed: many
    calls of other sizes, alternating between two streams, stay right."""
    from repro_torch.relational.join import join_match
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    rng = np.random.default_rng(8)
    cases = []
    for i in range(12):
        n = int(rng.integers(1, 300_000))
        pk = torch.from_numpy(rng.integers(0, 50_000, n)).to(dev)
        bk = torch.from_numpy(rng.integers(0, 50_000, 20_000)).to(dev)
        order, lo, counts = join_match(pk, bk)
        cases.append((order, lo, counts, ops.bucket_size(int(counts.sum()))))
    outs = []
    for i, (order, lo, counts, t_pad) in enumerate(cases):
        streams[i % 2].wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(streams[i % 2]):
            outs.append(ops.join_expand(order, lo, counts, counts, t_pad))
    torch.cuda.synchronize(dev)
    for (order, lo, counts, t_pad), got in zip(cases, outs):
        want = ref.join_expand_ref(order, lo, counts, counts, t_pad)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


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


# decode attention: (B, H, KVH, D, S); lengths below
DECODE_SHAPES = [(2, h, kvh, 64, s) for h, kvh in ((8, 8), (8, 4), (32, 8), (16, 1))
                 for s in (64, 700, 1536)] + [
    (4, 24, 8, 128, 1000),      # llama3.2-3b's heads, group 3
    (4, 28, 4, 128, 1000),      # qwen2-7b's heads, group 7
    (4, 28, 4, 64, 517),        # group 7, D = 64
    (3, 4, 2, 16, 40),          # the reduced configs' head_dim
    (2, 6, 2, 96, 300),         # D not a power of two
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,d,s", DECODE_SHAPES)
def test_decode_attention_on_card(dev, b, h, kvh, d, s, dtype):
    """Against the plain version: 2e-5 in float32, 3e-2 in bfloat16 (the
    reference's tolerances), at lengths 0, 1, S, S+1 and ragged ones.  In
    bfloat16 also element by element against the plain version on the
    inputs cast to float32, unrounded: within half a bf16 ulp (2^-8 of the
    value) plus 1e-5, since the kernel rounds a float32 result once."""
    rng = np.random.default_rng(b * h * d + s)
    tdt = getattr(torch, dtype)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32)).to(dev, tdt)
    k = torch.from_numpy(rng.normal(size=(b, s, kvh, d)).astype(np.float32)).to(dev, tdt)
    v = torch.from_numpy(rng.normal(size=(b, s, kvh, d)).astype(np.float32)).to(dev, tdt)
    edges = [0, 1, s, s + 1] if b >= 4 else [s, max(s // 3, 1), 0][:b]
    lengths = torch.tensor(edges + list(rng.integers(1, s + 1, b - len(edges))),
                           dtype=torch.int32, device=dev)
    build.reset_launch_counts()
    got = ops.decode_attention(q, k, v, lengths)
    assert build.launch_counts()["decode_attention"] == 1
    assert got.dtype == tdt and got.shape == q.shape
    want = ref.decode_attention_ref(q, k, v, lengths)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        exact = ref.decode_attention_ref(q.float(), k.float(), v.float(), lengths)
        assert ((got.float() - exact).abs() <= 2.0 ** -8 * exact.abs() + 1e-5).all()


def test_decode_attention_ignores_the_tail_on_card(dev):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 24, 128)).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.normal(size=(2, 400, 8, 128)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(2, 400, 8, 128)).astype(np.float32)).to(dev)
    lengths = torch.tensor([100, 257], dtype=torch.int32, device=dev)
    out1 = ops.decode_attention(q, k, v, lengths)
    k[0, 100:], v[0, 100:] = 99.0, -99.0
    k[1, 257:], v[1, 257:] = 99.0, -99.0
    out2 = ops.decode_attention(q, k, v, lengths)
    assert torch.equal(out1, out2)


def test_decode_attention_rejects_what_it_does_not_take(dev):
    q = torch.zeros((1, 4, 32), device=dev)
    kv = torch.zeros((1, 10, 2, 32), device=dev)
    n = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):             # float16
        ops.decode_attention(q.half(), kv.half(), kv.half(), n)
    with pytest.raises(ValueError):             # int64 lengths
        ops.decode_attention(q, kv, kv, n.long())
    with pytest.raises(ValueError):             # D = 20
        ops.decode_attention(q[..., :20].contiguous(), kv[..., :20].contiguous(),
                             kv[..., :20].contiguous(), n)
    with pytest.raises(ValueError):             # H not a multiple of KVH
        ops.decode_attention(torch.zeros((1, 3, 32), device=dev), kv, kv, n)


def test_reduced_decode_step_on_card_matches_the_cpu(dev):
    """One reduced llama3.2-3b, the same weights on both devices: logits and
    caches within 2e-4 over steps that fill the cache past its end, and one
    decode_attention launch per layer and step; serve gives the same greedy
    tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import CausalLM
    from repro_torch.serve_lm import serve
    cfg = reduced(get_config("llama3.2-3b"))
    cpu = CausalLM(cfg, device="cpu", seed=3)
    card = CausalLM(cfg, device=dev, seed=3)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (3, 12)))
    c_cpu, c_card = cpu.init_cache(3, 8), card.init_cache(3, 8)
    build.reset_launch_counts()
    for i in range(12):
        lg_cpu, c_cpu = cpu.decode_step(c_cpu, toks[:, i:i + 1])
        lg_card, c_card = card.decode_step(c_card, toks[:, i:i + 1].to(dev))
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=2e-4, atol=2e-4)
    assert build.launch_counts()["decode_attention"] == 12 * cfg.n_layers
    for a, b in zip(c_card["layers"], c_cpu["layers"]):
        torch.testing.assert_close(a["k"].cpu(), b["k"], rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(a["v"].cpu(), b["v"], rtol=2e-4, atol=2e-4)
    prompts = [list(range(1, n + 1)) for n in (5, 9, 3, 7)]
    assert serve(card, prompts, 6, 32)["tokens"] == serve(cpu, prompts, 6, 32)["tokens"]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v2-lite-16b"])
def test_reduced_family_on_card_matches_the_cpu(dev, arch):
    """Reduced jamba (Mamba, attention through the kernel, MoE) and
    deepseek (MLA, MoE, a dense prefix layer), the same weights on both
    devices, float32: the forward's logits and decode_step's logits and
    caches within 2e-4 over steps that fill the cache past its end, and one
    decode_attention launch per attention layer and step."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import CausalLM
    cfg = reduced(get_config(arch))
    cpu = CausalLM(cfg, device="cpu", seed=4)
    card = CausalLM(cfg, device=dev, seed=4)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (3, 12)))
    torch.testing.assert_close(card.logits_fn(card.forward(toks.to(dev))).cpu(),
                               cpu.logits_fn(cpu.forward(toks)),
                               rtol=2e-4, atol=2e-4)
    c_cpu, c_card = cpu.init_cache(3, 8), card.init_cache(3, 8)
    build.reset_launch_counts()
    for i in range(12):
        lg_cpu, c_cpu = cpu.decode_step(c_cpu, toks[:, i:i + 1])
        lg_card, c_card = card.decode_step(c_card, toks[:, i:i + 1].to(dev))
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=2e-4, atol=2e-4)
    n_attn = sum(k.mixer == "attn" for k in card.plan)
    assert n_attn == (2 if arch.startswith("jamba") else 0)
    assert build.launch_counts()["decode_attention"] == 12 * n_attn
    for a, b in zip(c_card["layers"], c_cpu["layers"]):
        assert set(a) == set(b)
        for key in a:
            torch.testing.assert_close(a[key].cpu(), b[key], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_reduced_encdec_and_vlm_on_card_match_the_cpu(dev, arch):
    """Reduced whisper (the encoder, cross-attention over the cached
    encoder output, learned positions) and llava (an image prefix), the
    same weights on both devices, float32: the forward's logits, and
    decode_step's logits over steps that fill the cache past its end,
    within 2e-4; one decode_attention launch per layer and step; serve
    (with frames for whisper) gives the same greedy tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import CausalLM
    from repro_torch.serve_lm import serve, workload_frames
    cfg = reduced(get_config(arch))
    cpu = CausalLM(cfg, device="cpu", seed=5)
    card = CausalLM(cfg, device=dev, seed=5)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 12)))
    frames = workload_frames(cfg, 3) if cfg.enc_layers else None
    extra = {}
    if cfg.enc_layers:
        extra["frames"] = torch.from_numpy(frames)
    if cfg.n_img_tiles:
        extra["img_embeds"] = torch.from_numpy(rng.standard_normal(
            (3, cfg.n_img_tiles * cfg.img_patches, cfg.d_model), np.float32))
    torch.testing.assert_close(
        card.logits_fn(card.forward(toks.to(dev), **{k: v.to(dev) for k, v
                                                     in extra.items()})).cpu(),
        cpu.logits_fn(cpu.forward(toks, **extra)), rtol=2e-4, atol=2e-4)
    c_cpu, c_card = cpu.init_cache(3, 8), card.init_cache(3, 8)
    if cfg.enc_layers:
        c_cpu["enc_out"] = cpu.encode(extra["frames"])
        c_card["enc_out"] = card.encode(extra["frames"].to(dev))
    build.reset_launch_counts()
    for i in range(12):
        lg_cpu, c_cpu = cpu.decode_step(c_cpu, toks[:, i:i + 1])
        lg_card, c_card = card.decode_step(c_card, toks[:, i:i + 1].to(dev))
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=2e-4, atol=2e-4)
    assert build.launch_counts()["decode_attention"] == 12 * cfg.n_layers
    prompts = [list(range(1, n + 1)) for n in (5, 9, 3)]
    assert serve(card, prompts, 6, 32, frames)["tokens"] == \
        serve(cpu, prompts, 6, 32, frames)["tokens"]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-medium",
                                  "jamba-v0.1-52b"])
def test_reduced_train_step_on_card_matches_the_cpu(dev, arch):
    """One float32 train step of a reduced config from the same masters on
    both devices (TF32 off): the loss and the gradient norm within 2e-5,
    each gradient leaf within 1e-4 of its norm, the new masters within a
    quarter of the step's learning rate (AdamW's first step divides each
    gradient element by its magnitude plus 1e-8)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.train_lm import synthetic_stream
    from repro_torch.training.optimizer import OptConfig, lr_schedule
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch))
    opt = OptConfig(warmup_steps=1, total_steps=10)
    batch = next(synthetic_stream(cfg.vocab, 2, 32, seed=6))
    rng = np.random.default_rng(6)
    if cfg.enc_layers:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model), np.float32))
    states, metrics, grads = {}, {}, {}
    cpu_state = init_train_state(cfg, device="cpu", seed=6)
    for name, device in (("cpu", "cpu"), ("card", dev)):
        state = {"params": {k: v.clone().to(device)
                            for k, v in cpu_state["params"].items()}}
        state["opt"] = {"mu": {k: torch.zeros_like(v) for k, v in state["params"].items()},
                        "nu": {k: torch.zeros_like(v) for k, v in state["params"].items()},
                        "step": torch.zeros((), dtype=torch.int32, device=device)}
        step = make_train_step(cfg, opt, device=device)
        states[name], metrics[name] = step(
            state, {k: v.to(device) for k, v in batch.items()}, keep_grads=True)
        grads[name] = {k: v.cpu() for k, v in metrics[name].pop("grads").items()}
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(metrics["card"][key].cpu(),
                                   metrics["cpu"][key], rtol=2e-5, atol=0)
    for k, want in grads["cpu"].items():
        err = float((grads["card"][k] - want).norm())
        assert err <= 1e-4 * float(want.norm()) + 1e-12, k
    lr = float(lr_schedule(opt, torch.tensor(1)))
    for k, want in states["cpu"]["params"].items():
        torch.testing.assert_close(states["card"]["params"][k].cpu(), want,
                                   rtol=1e-6, atol=0.25 * lr)


# the main path's decode shapes: (B, H, KVH, D, S, lengths) — the server's
# call, decode_32k's cache, float32 group 7 (run in float32 below as well),
# batch 1 over a full 32,768-row cache, the call of phi3.5-moe and jamba
# (group 4) and whisper's decoder self-attention (group 1, D = 64)
MAIN_DECODE = {
    "server": (8, 24, 8, 128, 8192, [122, 545, 300, 64, 576, 400, 190, 257]),
    "decode_32k": (4, 24, 8, 128, 32768, [32768, 32769, 1, 20000]),
    "group7": (4, 28, 4, 64, 1536, [0, 1, 1000, 1537]),
    "batch1_32k": (1, 24, 8, 128, 32768, [32768]),
    "group4": (8, 32, 8, 128, 8192, [347, 392, 190, 109, 73, 189, 178, 154]),
    "whisper": (8, 16, 16, 64, 8192, [512, 96, 301, 64, 576, 233, 450, 128]),
}


def _decode_inputs(dev, shape, dtype, seed):
    b, h, kvh, d, s, lengths = MAIN_DECODE[shape]
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)

    def draw(*size):
        return torch.from_numpy(rng.standard_normal(size, np.float32)).to(dev, tdt)

    return (draw(b, h, d), draw(b, s, kvh, d), draw(b, s, kvh, d),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(MAIN_DECODE))
def test_decode_attention_main_path_shapes_on_card(dev, shape, dtype):
    """The split kernel at the main path's shapes against the plain version
    (2e-5 in float32, 3e-2 in bf16, and in bf16 within half a bf16 ulp plus
    1e-5 of the plain version on the inputs cast to float32), one launch."""
    q, k, v, n = _decode_inputs(dev, shape, dtype, seed=len(shape))
    build.reset_launch_counts()
    got = ops.decode_attention(q, k, v, n)
    assert build.launch_counts()["decode_attention"] == 1
    want = ref.decode_attention_ref(q, k, v, n)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        exact = ref.decode_attention_ref(q.float(), k.float(), v.float(), n)
        assert ((got.float() - exact).abs() <= 2.0 ** -8 * exact.abs() + 1e-5).all()


@pytest.mark.parametrize("shape", ["server", "decode_32k", "batch1_32k"])
def test_decode_attention_is_bitwise_repeatable_on_card(dev, shape):
    """The last block to finish combines the splits in split order: the
    same input gives the same bits on every call."""
    q, k, v, n = _decode_inputs(dev, shape, "bfloat16", seed=7)
    first = ops.decode_attention(q, k, v, n)
    for _ in range(3):
        assert torch.equal(ops.decode_attention(q, k, v, n), first)


def test_decode_attention_on_two_streams_in_turn_on_card(dev):
    """Each stream keeps its own split counters and partials: calls that
    alternate between two streams stay right."""
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    cases = [_decode_inputs(dev, "server", "bfloat16", seed=i) for i in range(4)]
    outs = []
    for i, (q, k, v, n) in enumerate(cases):
        streams[i % 2].wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(streams[i % 2]):
            outs.append(ops.decode_attention(q, k, v, n))
    torch.cuda.synchronize(dev)
    for (q, k, v, n), got in zip(cases, outs):
        torch.testing.assert_close(got.float(), ref.decode_attention_ref(
            q, k, v, n).float(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("n", [1, 38, 64, 433, 1_024, 1_025])
def test_topk_select_sized_tiles_on_card(dev, n):
    """One round on a tile sized to n (n <= 1024) or the rounds above it:
    exact indices against the plain version, ties and +-0.0 included."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, max(n // 4, 2), n).astype(np.float32)
    x[: min(n, 4)] = np.array([0.0, -0.0, 0.0, -0.0], np.float32)[: min(n, 4)]
    keys = torch.from_numpy(x).to(dev)
    for k in sorted({1, min(n, 10), min(n, 128)}):
        build.reset_launch_counts()
        got = ops.topk_select(keys, k)
        assert build.launch_counts()["topk_select"] == 1
        assert torch.equal(got, ref.topk_select_ref(keys, k))


# ---------------------------------------------------------------------------
# the default path on the card: plan-cache replays as one CUDA graph
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.data.tpch import generate
    return generate(0.01)


def _loaded(db, **kw):
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.data.tpch import load_into_engine
    eng = SiriusEngine(**kw)
    load_into_engine(eng, db)
    return eng


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
        else:
            assert (got[k] == want[k]).all(), k


@pytest.mark.parametrize("qid", [1, 3, 13, 15, 18, 22])
def test_graph_replay_equals_closure_loop_and_eager_on_card(tpch_small, qid):
    from repro_torch.core import instrument
    from repro_torch.data.tpch_queries import QUERIES
    eng = _loaded(tpch_small)
    eager = _loaded(tpch_small, compile_pipelines=False)
    want = eager.execute(QUERIES[qid]()).to_host()
    _same(eng.execute(QUERIES[qid]()).to_host(), want)
    barriers = instrument.sync_barriers.value
    syncs = instrument.scalar_syncs.value
    graph = eng.execute(QUERIES[qid]())
    assert eng.executor.last_replay_mode == "graph"
    assert instrument.sync_barriers.value - barriers == 1
    assert instrument.scalar_syncs.value == syncs
    _same(graph.to_host(), want)
    # the result was cloned out of graph memory: a later replay leaves it
    held = {k: v.copy() for k, v in graph.to_host().items()}
    eng.execute(QUERIES[qid]())
    _same(graph.to_host(), held)
    entry = eng.executor.plan_cache._entries[eng.executor.last_plan_signature]
    entry.compiled = None
    closure = eng.execute(QUERIES[qid]()).to_host()
    assert eng.executor.last_replay_mode == "closure"
    _same(closure, want)


def test_replay_after_register_rerecords_on_card(tpch_small):
    from repro_torch.data.tpch_queries import QUERIES
    eng = _loaded(tpch_small)
    eng.execute(QUERIES[6]())
    eng.execute(QUERIES[6]())
    assert eng.executor.last_replay_mode == "graph"
    eng.register("lineitem", eng.buffers.get("lineitem"))
    got = eng.execute(QUERIES[6]()).to_host()
    assert not eng.executor.last_plan_cache_hit
    _same(got, _loaded(tpch_small, compile_pipelines=False).execute(
        QUERIES[6]()).to_host())
    eng.execute(QUERIES[6]())
    assert eng.executor.last_replay_mode == "graph"


def test_changed_recorded_scalar_raises_replay_mismatch_on_card(tpch_small):
    """Data changed in place under a captured graph (no epoch bump): the
    graph's folded flag is set, the replay raises ReplayMismatch once, and
    the cold re-run answers for the new data."""
    from repro_torch.data.tpch_queries import QUERIES
    eng = _loaded(tpch_small)
    eng.execute(QUERIES[6]())
    eng.execute(QUERIES[6]())
    assert eng.executor.last_replay_mode == "graph"
    disc = eng.buffers.get("lineitem")["l_discount"].data
    disc.fill_(0.06)                      # every row now in Q6's range
    got = eng.execute(QUERIES[6]()).to_host()
    stats = eng.executor.plan_cache.stats
    assert stats["replay_mismatches"] == 1
    assert not eng.executor.last_plan_cache_hit
    eager = _loaded(tpch_small, compile_pipelines=False)
    eager.register("lineitem", eng.buffers.get("lineitem"))
    _same(got, eager.execute(QUERIES[6]()).to_host())
    eng.execute(QUERIES[6]())
    assert eng.executor.last_replay_mode == "graph"
    assert stats["replay_mismatches"] == 1


def test_capture_outlives_a_graph_the_collector_frees_on_card(tpch_small):
    """A CUDA graph freed by the cyclic collector while another is being
    captured would invalidate that capture: Q6's capture drops the last
    reference from outside a cycle that holds a graph, with the collector
    set to run at nearly every allocation, and still captures."""
    import gc
    from repro_torch.data.tpch_queries import QUERIES
    eng = _loaded(tpch_small)
    side = torch.cuda.Stream()
    x = torch.ones(4, device="cuda")
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        y = x * 2
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    thresholds = gc.get_threshold()
    gc.freeze()                        # the collections below scan only new objects
    cycle = [graph, y]
    cycle.append(cycle)
    holder = {"cycle": cycle}
    del graph, y, cycle
    core = eng.executor._replay_core

    def core_dropping_the_cycle(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing() and holder["cycle"] is not None:
            holder["cycle"] = None     # now only the collector frees the graph
            gc.set_threshold(1, 1, 1)
        return core(*args, **kwargs)

    eng.executor._replay_core = core_dropping_the_cycle
    try:
        eng.execute(QUERIES[6]())
    finally:
        gc.set_threshold(*thresholds)
        gc.unfreeze()
    assert holder["cycle"] is None     # the capture ran
    assert eng.executor.capture_errors == {}
    eng.execute(QUERIES[6]())
    assert eng.executor.last_replay_mode == "graph"


def test_fixed_point_sums_are_order_free_on_card(dev):
    """The generic tier's float sums on the card: one answer whatever the
    row order, integer-valued columns exact, within 1e-12 of float64."""
    from repro_torch.relational.aggregate import segment_sum
    rng = np.random.default_rng(15)
    n = 1_000_000
    ids = torch.from_numpy(rng.integers(0, 7, n)).to(dev)
    x = torch.from_numpy(rng.integers(90000, 10494950, n) / 100.0).to(dev)
    q = torch.from_numpy(rng.integers(1, 51, n).astype(np.float64)).to(dev)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    a = segment_sum(x, ids, 7)
    assert torch.equal(a, segment_sum(x[perm], ids[perm], 7))
    want = torch.zeros(7, dtype=torch.float64).index_add_(0, ids.cpu(), x.cpu())
    assert float(((a.cpu() - want).abs() / want).max()) < 1e-12
    exact = torch.zeros(7, dtype=torch.float64).index_add_(0, ids.cpu(), q.cpu())
    assert torch.equal(segment_sum(q, ids, 7).cpu(), exact)


# ---------------------------------------------------------------------------
# the Substrait front door on the card
# ---------------------------------------------------------------------------

GOLDEN_DIR = Path(__file__).resolve().parent / "golden" / "substrait"


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("qid", [1, 3, 13, 21])
def test_accelerate_golden_wire_equals_sql_on_card(tpch_small, qid,
                                                   use_kernels):
    """A golden wire through ``accelerate`` on the card: one device
    fragment, no boundary bytes, the result on the card and equal to
    ``sql()``; the warm call is a plan-cache hit by the wire bytes (one
    CUDA graph on ``SiriusEngine()``)."""
    from repro_torch.core import instrument
    from repro_torch.data.tpch_queries import SQL_QUERIES
    eng = _loaded(tpch_small, use_kernels=use_kernels)
    blob = (GOLDEN_DIR / f"tpch_q{qid}.json").read_bytes()
    want = _loaded(tpch_small, compile_pipelines=False).sql(
        SQL_QUERIES[qid]).to_host()
    cold = eng.accelerate(blob)
    assert cold.device.type == "cuda"
    report = eng.last_accelerate_report
    assert (report["device_fragments"], report["host_fragments"],
            report["device_rel_fraction"], report["boundary_to_host_bytes"],
            report["boundary_to_device_bytes"]) == (1, 0, 1.0, 0, 0)
    _same(cold.to_host(), want)
    barriers = instrument.sync_barriers.value
    syncs = instrument.scalar_syncs.value
    warm = eng.accelerate(blob)
    assert eng.last_accelerate_report["plan_cache_hit"] is True
    assert instrument.sync_barriers.value - barriers == 1
    assert instrument.scalar_syncs.value == syncs
    assert eng.executor.last_replay_mode == (
        "closure" if use_kernels else "graph")
    _same(warm.to_host(), want)
    _same(eng.sql(SQL_QUERIES[qid]).to_host(), want)


def test_accelerate_hybrid_plan_stays_on_card(tpch_small):
    """A window plan routes device → host → device; the host fragment's
    result is cached on the card, and the boundary bytes equal the buffer
    manager's counters."""
    from repro_torch.core.fallback import FallbackEngine
    from repro_torch.core.plan import FilterRel, ReadRel, WindowRel
    from repro_torch.relational.expressions import BinOp, Col, Lit
    from repro_torch.relational.sort import SortKey
    from repro_torch.sql.binder import DEFAULT_CATALOG
    from repro_torch.substrait import emit

    def plan():
        return FilterRel(
            WindowRel(ReadRel("lineitem", ["l_orderkey", "l_quantity"]),
                      ["l_orderkey"], [SortKey("l_quantity", False)],
                      "row_number", None, "rn"),
            BinOp("==", Col("rn"), Lit(1)))

    eng = _loaded(tpch_small, use_kernels=True)
    h0 = eng.buffers.boundary_to_host_bytes
    d0 = eng.buffers.boundary_to_device_bytes
    got = eng.accelerate(emit(plan(), DEFAULT_CATALOG))
    report = eng.last_accelerate_report
    assert [f["placement"] for f in report["fragments"]] == \
        ["device", "host", "device"]
    assert got.device.type == "cuda"
    assert eng.buffers.boundary_to_host_bytes - h0 == \
        report["boundary_to_host_bytes"] > 0
    assert eng.buffers.boundary_to_device_bytes - d0 == \
        report["boundary_to_device_bytes"] > 0
    _same(got.to_host(), FallbackEngine(tpch_small).execute(plan()))


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE and the journal on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
def test_analyzed_q6_equals_plain_and_keeps_the_warm_barrier_on_card(
        tpch_small, use_kernels):
    """An analyzed Q6 equals the plain run and takes more than one barrier;
    the plain warm run after it is still a replay with one barrier and no
    scalar sync (one CUDA graph without kernels)."""
    from repro_torch.core import instrument
    from repro_torch.data.tpch_queries import QUERIES
    from repro_torch.observability import validate_profile
    eng = _loaded(tpch_small, use_kernels=use_kernels)
    want = eng.execute(QUERIES[6]()).to_host()
    eng.execute(QUERIES[6]())
    barriers = instrument.sync_barriers.value
    got = eng.execute(QUERIES[6](), analyze=True)
    assert instrument.sync_barriers.value - barriers > 1
    assert got.device.type == "cuda"
    _same(got.to_host(), want)
    prof = eng.last_profile.to_dict()
    assert validate_profile(prof) == []
    assert prof["pipelines"][-1]["operators"][-1]["rows_out"] == got.num_rows
    barriers = instrument.sync_barriers.value
    syncs = instrument.scalar_syncs.value
    warm = eng.execute(QUERIES[6]())
    assert eng.executor.last_plan_cache_hit
    assert eng.executor.last_replay_mode == (
        "closure" if use_kernels else "graph")
    assert instrument.sync_barriers.value - barriers == 1
    assert instrument.scalar_syncs.value == syncs
    _same(warm.to_host(), want)


def test_journal_clean_of_a_cuda_tensor_neither_copies_nor_syncs_on_card(dev):
    """With the card busy (a spin kernel queued), describing CUDA tensors as
    journal attributes copies nothing to the host and does not wait: the
    stream is still busy after."""
    from repro_torch.core import instrument
    from repro_torch.observability.journal import JOURNAL
    x = torch.arange(1 << 20, device=dev)
    s = torch.tensor(2.5, device=dev)
    torch.cuda.synchronize(dev)
    with instrument.track_transfers() as counter:
        torch.cuda._sleep(1 << 30)            # ~0.5 s of device spin
        attrs = JOURNAL._clean({"cols": x, "k": s})
        busy = not torch.cuda.current_stream(dev).query()
    torch.cuda.synchronize(dev)
    assert counter.total == 0
    assert busy, "describing a CUDA tensor waited for the device"
    assert attrs["cols"] == \
        "Tensor(shape=(1048576,), dtype=torch.int64, device=cuda:0)"
    assert attrs["k"] == "Tensor(shape=(), dtype=torch.float32, device=cuda:0)"


def test_chrome_trace_of_an_engine_query_on_card(tpch_small):
    from repro_torch.data.tpch_queries import SQL_QUERIES
    from repro_torch.observability.dist import verify_tree
    from repro_torch.observability.journal import JOURNAL, to_chrome
    eng = _loaded(tpch_small)
    eng.sql(SQL_QUERIES[6])
    eng.sql(SQL_QUERIES[6])
    evs = JOURNAL.events(eng.last_query_id)
    assert verify_tree(evs, eng.last_query_id) == []
    d = to_chrome(evs, epoch=JOURNAL.epoch)
    spans = [e for e in d["traceEvents"] if e["ph"] == "X"]
    # a graph replay is one launch: no operator spans, one barrier
    assert {e["name"] for e in spans} == {"sql", "engine.execute",
                                          "plan_cache.replay",
                                          "executor.barrier"}
    assert [e["name"] for e in evs].count("executor.barrier") == 1
    assert all(e["dur"] > 0 for e in spans)
    assert [e["args"]["name"] for e in d["traceEvents"]
            if e["ph"] == "M"] == ["coordinator"]
    replay = next(e for e in spans if e["name"] == "plan_cache.replay")
    assert replay["args"]["mode"] == "graph"


# ---------------------------------------------------------------------------
# distributed execution and the static tier on the card
# ---------------------------------------------------------------------------


def test_partition_hash_on_card_equals_the_host_hash(dev):
    from repro_torch.core.distributed import np_partition_hash
    from repro_torch.exchange.service import partition_hash
    rng = np.random.default_rng(20)
    keys = np.concatenate([
        np.array([0, 1, -5, 2**40, -(2**40), np.iinfo(np.int64).max,
                  np.iinfo(np.int64).min], np.int64),
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 100_000,
                     dtype=np.int64)])
    for n in (2, 3, 7, 8, 16):
        got = partition_hash(torch.from_numpy(keys).to(dev), n)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      np_partition_hash(keys, n))


@pytest.mark.parametrize("out_cap", [4096, 64])
def test_shuffle_on_card_equals_the_cpu_shuffle(dev, out_cap):
    from repro_torch.exchange.service import Frame, ShardMesh, shuffle
    rng = np.random.default_rng(out_cap)
    n, cap = 8, 2048
    cols = {"k": rng.integers(-(2**40), 2**40, (n, cap)),
            "v": rng.normal(size=(n, cap)),
            "m": rng.integers(0, 99, (n, cap, 3)).astype(np.int32)}
    valid = rng.random((n, cap)) < 0.8
    outs = []
    for d in (torch.device("cpu"), dev):
        fr = Frame({k: torch.from_numpy(v).to(d) for k, v in cols.items()},
                   torch.from_numpy(valid).to(d))
        got, ov = shuffle(fr, fr.columns["k"], ShardMesh.of(n, d), out_cap)
        outs.append(({k: v.cpu() for k, v in got.columns.items()},
                     got.valid.cpu(), ov.cpu()))
    (c_cols, c_valid, c_ov), (g_cols, g_valid, g_ov) = outs
    assert torch.equal(c_valid, g_valid) and torch.equal(c_ov, g_ov)
    for k in cols:
        assert torch.equal(c_cols[k], g_cols[k]), k
    assert (int(g_ov[0]) > 0) == (out_cap == 64)


def test_hash_join_bounded_is_sync_free_on_card(dev):
    """Single-column keys: no host sync (torch's sync debug mode raises on
    one), the reference's zero-sync contract."""
    from repro_torch.relational.join import hash_join, hash_join_bounded
    from repro_torch.relational.table import Column, Table
    rng = np.random.default_rng(3)

    def table(**cols):
        return Table({k: Column(torch.from_numpy(v).to(dev))
                      for k, v in cols.items()})
    probe = table(k=rng.integers(0, 80, 5000),
                  pv=rng.normal(size=5000).astype(np.float32))
    build = table(k=rng.integers(0, 80, 2000), bv=rng.integers(0, 1000, 2000))
    for how in ("inner", "left"):
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, valid, overflow = hash_join_bounded(
                probe, build, ["k"], ["k"], capacity=1 << 18, how=how)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        exact = hash_join(probe, build, ["k"], ["k"], how=how)
        assert not bool(overflow) and int(valid.sum()) == exact.num_rows
        for name in exact.column_names:
            got = out[name].data[valid]
            assert torch.equal(got, exact[name].data), (how, name)


def test_distributed_q3_with_kernels_equals_the_eager_engine_on_card(
        tpch_small):
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.data.tpch_queries import QUERIES
    eng = DistributedEngine(tpch_small, n_shards=4, use_kernels=True)
    assert eng.device.type == "cuda"
    before = build.launch_counts()
    got = eng.run_plan(QUERIES[3]())
    launched = {k: n - before[k] for k, n in build.launch_counts().items()}
    want = _loaded(tpch_small, compile_pipelines=False).execute(
        QUERIES[3]()).to_host()
    assert set(got) == set(want)
    for k in want:
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6)
        else:
            assert (np.asarray(got[k]) == np.asarray(want[k])).all(), k
    assert launched["hash_probe"] + launched["groupby_sum"] > 0
    assert all(t["master"].device.type == "cuda"
               for t in eng.tables.values())


# ---------------------------------------------------------------------------
# launch/: the SQL fragments on logical shards of the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["q1", "q3"])
def test_sql_fragment_on_card_equals_the_plain_answer(dev, shape, multi_pod):
    """8 shards at SF0.5: Q1's sums (summed in fixed point on the card,
    one float32 rounding of five float32 roundings a term) and Q3's
    overflow (0) and each shard's top-10."""
    from repro_torch.exchange.service import ShardMesh
    from repro_torch.launch import sql_data, sql_dryrun
    mesh = (ShardMesh((("pod", 2), ("data", 4)), dev) if multi_pod
            else ShardMesh.of(8, dev))
    fn, _, extra = sql_dryrun.lower_sql_fragment(shape, multi_pod, sf=0.5,
                                                 mesh=mesh)
    if shape == "q1":
        data = sql_data.q1_data(extra, 0.5, 7, device=dev)
        sql_data.hold_q1(fn(mesh, *data), sql_data.plain_q1(*data),
                         rtol=6 * 2.0 ** -24)
        return
    data = sql_data.q3_data(extra, 0.5, 7, device=dev)
    got = fn(mesh, *data)
    plain = sql_data.plain_q3(data, extra, 2 if multi_pod else 1, False)
    assert int(got[-1]) == plain["overflow"] == 0
    sql_data.hold_q3(got, plain, 8, rtol=4 * 2.0 ** -24)
    # the same fragment again gives the same answer to the bit
    again = fn(mesh, *data)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_sql_dry_run_on_card_takes_the_card_branch(dev):
    """The dry run's fake CUDA tensors sum floats as the card does: in fixed
    point (a float64 copy and two int64 ones of the (N, 6) matrix)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(dryrun.SQL_ARCH, "q1_sf100", False)
    assert rec["status"] == "ok" and rec["memory"]["fits_card"]
    assert rec["memory"]["card_bytes"] == torch.cuda.get_device_properties(
        0).total_memory
    cap = rec["cap"]
    assert rec["memory"]["temp_bytes"] > cap * 6 * (8 + 8 + 8)


# ---------------------------------------------------------------------------
# the model dry run's shard programs (launch/model_dryrun.py)
# ---------------------------------------------------------------------------


def test_dry_run_counts_decode_attention_by_its_formula_on_card(dev):
    """On the card's build the wrapper still counts a tensor that holds no
    data by its formula and launches nothing; a real card tensor launches
    the kernel once, as before."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_flops,
    )
    from repro_torch.launch.analysis import OpCounter
    b, h, kvh, d, s = 2, 8, 4, 64, 300
    lengths = torch.tensor([300, 17], dtype=torch.int32, device=dev)
    before = build.launch_counts()["decode_attention"]
    with OpCounter() as counter:
        out = decode_attention(torch.empty(b, h, d, device="meta"),
                               torch.empty(b, s, kvh, d, device="meta"),
                               torch.empty(b, s, kvh, d, device="meta"),
                               lengths.to("meta"))
    assert out.is_meta and out.shape == (b, h, d)
    assert counter.flops == decode_attention_flops((b, h, d), (b, s, kvh, d))
    assert build.launch_counts()["decode_attention"] == before
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b, h, d, generator=g, device=dev)
    k = torch.randn(b, s, kvh, d, generator=g, device=dev)
    got = decode_attention(q, k, k, lengths)
    assert build.launch_counts()["decode_attention"] == before + 1
    torch.testing.assert_close(got, ref.decode_attention_ref(q, k, k, lengths),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_shard_program_peak_on_card_within_its_prediction(dev, kind):
    """A reduced llama3.2-3b cell's shard program on a (2, 4) mesh, run for
    real on the card, peaks within 25% of the dry run's prediction (phase
    6e's limit)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import Shape
    from repro_torch.exchange.service import ShardMesh
    from repro_torch.launch import dryrun
    cfg = reduced(get_config("llama3.2-3b"))
    shape = Shape("train_4k", 2048, 16, "train") if kind == "train" \
        else Shape("prefill_32k", 4096, 16, "prefill")
    axes = (("data", 2), ("model", 4))
    pred = dryrun.model_record(
        "llama3.2-3b", shape.name, False, cfg=cfg, shape=shape,
        mesh=ShardMesh(axes, torch.device("meta")))["memory"][
            "resident_bytes_per_chip"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, _, cell = dryrun.lower_cell("llama3.2-3b", shape.name, False, cfg=cfg,
                                   shape=shape, mesh=ShardMesh(axes, dev),
                                   device=dev, sample=False, seed=5)
    out = cell.run(None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert all(torch.isfinite(o).all() for o in
               (out if isinstance(out, tuple) else (out,)))
    assert abs(peak / pred - 1) <= 0.25, (peak, pred)


def test_quickstart_fallback_on_card(dev):
    """A table only the host holds runs on the host, launching nothing;
    once registered, the same plan runs on the card through the kernels."""
    from repro_torch import quickstart
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.relational import Table
    eng = SiriusEngine(use_kernels=True, device=dev)
    mystery = {"x": np.arange(4.0)}
    eng.host_tables["mystery"] = mystery
    launches = build.launch_counts()
    res, route = eng.execute_with_fallback(quickstart.fallback_plan())
    assert (route, float(res["s"][0])) == ("fallback", 6.0)
    assert build.launch_counts() == launches
    assert eng.executor.fallback_queries == 1
    eng.register("mystery", Table.from_pydict(mystery), host_data=mystery)
    out, route = eng.execute_with_fallback(quickstart.fallback_plan())
    assert route == "accelerator" and out["s"].data.device.type == "cuda"
    assert float(out.to_host()["s"][0]) == 6.0


@pytest.mark.parametrize("n,k", [(100_000_000, 10), (100_000_000, 128),
                                 (1_025, 128), (433, 10), (1, 1)])
def test_topk_select_int64_on_card(dev, n, k):
    """int64 ranks wider than float32 holds exactly (ClickBench's count
    DESC, key composites), with heavy ties and negative keys: exact
    indices against the plain version (a stable sort)."""
    g = torch.Generator(device=dev)
    g.manual_seed(n + k)
    keys = (torch.randint(0, 1000, (n,), device=dev, generator=g) * 2**40
            + torch.randint(0, 3, (n,), device=dev, generator=g) - 2**45)
    build.reset_launch_counts()
    got = ops.topk_select(keys, k)
    assert build.launch_counts()["topk_select"] == 1
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, ref.topk_select_ref(keys, k))


@pytest.mark.parametrize("n,groups", [(2**24 + 1, 7), (2**24 + 1, 300_000),
                                      (3 * 2**24 + 5, 5_000)])
def test_groupby_row_chunks_on_card(dev, n, groups):
    """A group-by past 2^24 rows runs groupby_sum on chunks of 2^24 rows:
    counts exact in int64, sums and averages as the generic path's."""
    from repro_torch.core.kernel_backend import ROW_BOUND, KernelBackend
    from repro_torch.observability.metrics import METRICS
    from repro_torch.relational.aggregate import AggSpec, group_aggregate
    from repro_torch.relational.expressions import Col
    from repro_torch.relational.table import Column, Table
    g = torch.Generator(device=dev)
    g.manual_seed(n + groups)
    t = Table({"k": Column(torch.randint(0, groups, (n,), device=dev, generator=g)),
               "v": Column(torch.randint(0, 2000, (n,), device=dev, generator=g))})
    aggs = [AggSpec("count_star", None, "c"), AggSpec("sum", Col("v"), "s"),
            AggSpec("avg", Col("v"), "a"), AggSpec("max", Col("v"), "m")]
    chunks = METRICS.counter("kernel.groupby_row_chunks")
    before = chunks.value
    got = KernelBackend().try_aggregate(t, ["k"], aggs).to_host()
    assert chunks.value - before == -(-n // ROW_BOUND)
    want = group_aggregate(t, ["k"], aggs).to_host()
    assert got["c"].dtype == np.int64 and got["c"].sum() == n
    for c in ("k", "c", "s", "m"):
        np.testing.assert_array_equal(got[c], want[c])
    np.testing.assert_allclose(got["a"], want["a"], rtol=1e-12)
