"""The port's kernel layer against the JAX package, on the CPU.

Each plain PyTorch version in ``repro_torch.kernels.ref`` (what the kernel
wrappers run for CPU tensors) is held against the Pallas kernel in
interpret mode and against ``repro/kernels/ref.py``; the plain-torch glue
(``build_table32``, ``sorted_build``, ``compact``, ...) against its jnp
counterpart, bit for bit.  Inputs are numpy arrays made from a seed and
handed to both packages.  The CUDA kernels themselves are checked on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.filter_count import filter_mask_counts as pallas_filter
from repro.kernels.groupby_agg import groupby_sum as pallas_groupby
from repro.kernels.hash_probe import _hash as jax_hash32
from repro.kernels.hash_probe import hash_probe as pallas_probe
from repro.kernels.join_expand import join_expand as pallas_expand
from repro.relational import join as jjoin
from repro_torch.kernels import build, ops, ref
from repro_torch.relational.join import join_match

# the suite runs files in parallel worker processes: keep torch to one
# thread so the workers do not oversubscribe the cores
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.asarray(a))


def N(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# filter_mask_counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2047, 2048, 5000])
@pytest.mark.parametrize("c", [1, 3])
def test_filter_mask_counts_matches_pallas_and_ref(n, c):
    rng = np.random.default_rng(n * 7 + c)
    cols = rng.uniform(-1, 1, size=(n, c)).astype(np.float32)
    lo = rng.uniform(-1, 0, c).astype(np.float32)
    hi = rng.uniform(0, 1, c).astype(np.float32)
    mask, counts = ops.filter_mask_counts(T(cols), T(lo), T(hi))
    p_mask, p_counts = pallas_filter(jnp.asarray(cols), jnp.asarray(lo),
                                     jnp.asarray(hi), interpret=True)
    r_mask, r_counts = jref.filter_mask_counts_ref(
        jnp.asarray(cols), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(N(mask), np.asarray(p_mask))
    np.testing.assert_array_equal(N(mask), np.asarray(r_mask))
    np.testing.assert_array_equal(N(counts), np.asarray(r_counts))
    np.testing.assert_array_equal(N(counts), np.asarray(p_counts))


def test_filter_counts_with_open_upper_bound_follow_ref_not_pallas():
    """With hi=+inf the Pallas kernel's +inf padding rows pass, so its last
    tile count includes them; the port (like ref.py) counts real rows only."""
    cols = np.arange(3, dtype=np.float32)[:, None]
    lo, hi = np.float32([0.0]), np.float32([np.inf])
    _, counts = ops.filter_mask_counts(T(cols), T(lo), T(hi))
    _, r_counts = jref.filter_mask_counts_ref(jnp.asarray(cols),
                                              jnp.asarray(lo), jnp.asarray(hi))
    _, p_counts = pallas_filter(jnp.asarray(cols), jnp.asarray(lo),
                                jnp.asarray(hi), interpret=True)
    assert N(counts).tolist() == np.asarray(r_counts).tolist() == [3]
    assert np.asarray(p_counts).tolist() == [2048]


def test_filter_select_compacts_in_row_order():
    rng = np.random.default_rng(3)
    cols = rng.uniform(0, 10, size=(3000, 2)).astype(np.float32)
    lo, hi = np.float32([2.0, 1.0]), np.float32([7.0, 9.0])
    idx, count = ops.filter_select(T(cols), T(lo), T(hi))
    j_idx, j_count = jops.filter_select(jnp.asarray(cols), jnp.asarray(lo),
                                        jnp.asarray(hi))
    assert int(count) == int(j_count)
    np.testing.assert_array_equal(N(idx), np.asarray(j_idx))


# ---------------------------------------------------------------------------
# groupby_sum
# ---------------------------------------------------------------------------


def _sum_abs(gids, vals, g):
    out = np.zeros((g, vals.shape[1]))
    ok = (gids >= 0) & (gids < g)
    np.add.at(out, gids[ok], np.abs(vals[ok].astype(np.float64)))
    return out


@pytest.mark.parametrize("n", [1, 17, 1024, 5000])
@pytest.mark.parametrize("n_groups", [1, 7, 200])
@pytest.mark.parametrize("v_cols", [1, 3])
def test_groupby_sum_matches_pallas_and_ref(n, n_groups, v_cols):
    """Float32 sums taken in another order differ in their last bits, so
    the tolerance is 1e-6 x sum|v| per (group, column)."""
    rng = np.random.default_rng(n * 31 + n_groups)
    gids = rng.integers(0, n_groups, n).astype(np.int32)
    vals = rng.normal(size=(n, v_cols)).astype(np.float32)
    got = N(ops.groupby_sum(T(gids), T(vals), n_groups)).astype(np.float64)
    pallas = np.asarray(pallas_groupby(jnp.asarray(gids), jnp.asarray(vals),
                                       n_groups, interpret=True))
    oracle = np.asarray(jref.groupby_sum_ref(jnp.asarray(gids),
                                             jnp.asarray(vals), n_groups))
    tol = 1e-6 * _sum_abs(gids, vals, n_groups) + 1e-30
    assert got.shape == pallas.shape == (n_groups, v_cols)
    assert (np.abs(got - pallas) <= tol).all()
    assert (np.abs(got - oracle) <= tol).all()


def test_groupby_sum_drops_out_of_range_gids():
    gids = np.int32([0, 1, 99999, -1, 1])
    vals = np.ones((5, 1), np.float32)
    got = N(ops.groupby_sum(T(gids), T(vals), 2)).ravel()
    pallas = np.asarray(pallas_groupby(jnp.asarray(gids), jnp.asarray(vals), 2,
                                       interpret=True)).ravel()
    assert got.tolist() == pallas.tolist() == [1.0, 2.0]


def test_groupby_sum_large_partitions_like_the_reference():
    rng = np.random.default_rng(11)
    n_groups = 9000            # beyond one call's 4096 groups: three calls
    gids = rng.integers(0, n_groups, 6000).astype(np.int32)
    vals = rng.normal(size=(6000, 2)).astype(np.float32)
    got = N(ops.groupby_sum_large(T(gids), T(vals), n_groups))
    want = np.asarray(jops.groupby_sum_large(jnp.asarray(gids),
                                             jnp.asarray(vals), n_groups))
    tol = 1e-6 * _sum_abs(gids, vals, n_groups) + 1e-30
    assert got.shape == want.shape
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


# ---------------------------------------------------------------------------
# hash_probe and its table build
# ---------------------------------------------------------------------------


def test_hash32_wraps_like_int32():
    rng = np.random.default_rng(5)
    keys = np.concatenate([
        rng.integers(-2**31, 2**31, 5000),
        [0, 1, -1, -2, 2**31 - 1, -2**31]]).astype(np.int32)
    for mask in (15, 2**16 - 1, 2**19 - 1):
        np.testing.assert_array_equal(
            N(ref.hash32(T(keys), mask)),
            np.asarray(jax_hash32(jnp.asarray(keys), mask)))


def _tables(build_keys):
    """Port and reference sorted_build + build_table32 on the same keys."""
    n = len(build_keys)
    nb = ops.bucket_size(n)
    valid = np.arange(nb) < n
    t_out = ops.sorted_build(ops.pad_rows(T(build_keys), nb), T(valid))
    j_out = jops.sorted_build(jops.pad_rows(jnp.asarray(build_keys), nb),
                              jnp.asarray(valid))
    b32 = torch.where(T(valid), t_out[2], -1).to(torch.int32)
    jb32 = jnp.where(jnp.asarray(valid), j_out[2], -1).astype(jnp.int32)
    t_tab = ops.build_table32(b32, T(valid))
    j_tab = jops.build_table32(jb32, jnp.asarray(valid))
    return t_out, j_out, t_tab, j_tab


@pytest.mark.parametrize("n_build", [1, 5, 300, 2000])
def test_sorted_build_and_build_table32_bit_exact(n_build):
    rng = np.random.default_rng(n_build)
    keys = rng.choice(10 * n_build + 10, n_build, replace=False).astype(np.int64) - 7
    t_out, j_out, t_tab, j_tab = _tables(keys)
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    for a, b in zip(t_tab, j_tab):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    assert bool(t_tab[2])


def test_sorted_build_flags_duplicates_like_the_reference():
    keys = np.int64([4, 9, 4, 1])
    t_out, j_out, _, _ = _tables(keys)
    assert bool(t_out[3]) and bool(j_out[3])


@pytest.mark.parametrize("n,placed", [(150_000, True), (227_000, False)])
def test_build_table32_declines_at_q5_sf1_build_size(n, placed):
    """At ~227,000 build rows (Q5's 1994 orders at SF1) some keys need more
    than 32 rounds, in both packages, so try_probe declines there; the
    slot arrays agree bit for bit either way."""
    nb = ops.bucket_size(n)
    valid = np.arange(nb) < n
    keys = np.where(valid, np.random.default_rng(n).permutation(nb), -1)
    t_tab = ops.build_table32(T(keys.astype(np.int32)), T(valid))
    j_tab = jops.build_table32(jnp.asarray(keys, jnp.int32), jnp.asarray(valid))
    assert bool(t_tab[2]) is placed and bool(j_tab[2]) is placed
    for a, b in zip(t_tab[:2], j_tab[:2]):
        np.testing.assert_array_equal(N(a), np.asarray(b))


def _colliding_table(n: int):
    """``2 n`` int32 keys whose first slot is slot 3 of a table for ``n``
    rows, and the table of the first ``n`` in both packages (one chain of
    n slots; built with 2 n rounds so that every key is placed)."""
    mask = ops.bucket_size(2 * n) - 1
    cand = np.arange(2_000_000, dtype=np.int32)
    keys = cand[N(ref.hash32(T(cand), mask)) == 3][:2 * n]
    t_tab = ops.build_table32(T(keys[:n]), max_probes=2 * n)
    j_tab = jops.build_table32(jnp.asarray(keys[:n]), max_probes=2 * n)
    for a, b in zip(t_tab, j_tab):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    assert bool(t_tab[2]) and t_tab[0].shape[0] == mask + 1
    return keys, t_tab, j_tab


@pytest.mark.parametrize("n_build,n_probe,mix,max_probes", [
    pytest.param(1, 10, "uniform", 32, id="1-10"),
    pytest.param(100, 1000, "uniform", 32, id="100-1000"),
    pytest.param(2000, 5000, "uniform", 32, id="2000-5000"),
    pytest.param(3000, 30_000, "q3-like", 32, id="q3-like"),
    pytest.param(40, 300, "colliding", 1, id="colliding-max1"),
    pytest.param(40, 300, "colliding", 2, id="colliding-max2"),
    pytest.param(40, 300, "colliding", 32, id="colliding-max32")])
def test_hash_probe_matches_pallas_and_ref(n_build, n_probe, mix, max_probes):
    """The port's plain version, the Pallas kernel (interpret mode) and the
    jnp ref agree: keys around the build's range; a mix like Q3's second
    call at SF1 (~1% hits, every other key the absent rank -2); and one
    chain of 40 colliding keys cut short by max_probes 1, 2 and 32."""
    rng = np.random.default_rng(n_build + n_probe + max_probes)
    if mix == "colliding":
        keys, t_tab, j_tab = _colliding_table(n_build)
        # the n_build keys in the table, n_build more on its chain, others
        p32 = np.concatenate([keys, rng.integers(0, 2**31 - 1, n_probe)]
                             ).astype(np.int32)
        jp32 = jnp.asarray(p32)
        p32 = T(p32)
    else:
        keys = rng.choice(5 * n_build + 5, n_build, replace=False).astype(np.int64)
        if mix == "q3-like":
            probe = np.where(rng.random(n_probe) < 0.01, rng.choice(keys, n_probe),
                             5 * n_build + 5 + rng.integers(0, 10**6, n_probe))
        else:
            probe = rng.integers(-3, 5 * n_build + 8, n_probe).astype(np.int64)
        t_out, j_out, t_tab, j_tab = _tables(keys)
        p32 = ops.map_probe_keys(t_out[0], T(probe))
        jp32 = jops.map_probe_keys(j_out[0], jnp.asarray(probe))
        np.testing.assert_array_equal(N(p32), np.asarray(jp32))
    row, found = ops.hash_probe(p32, t_tab[0], t_tab[1], max_probes)
    p_row, p_found = pallas_probe(jp32, j_tab[0], j_tab[1], max_probes,
                                  interpret=True)
    r_row, r_found = jref.hash_probe_ref(jp32, j_tab[0], j_tab[1], max_probes)
    for got, want in ((row, p_row), (found, p_found), (row, r_row),
                      (found, r_found)):
        np.testing.assert_array_equal(N(got), np.asarray(want))
    if mix == "colliding":
        # the key placed k-th sits k slots down the chain: found iff k <
        # max_probes
        assert int(found.sum()) == min(max_probes, n_build)
    else:
        # the probe finds exactly the keys that are in the build
        np.testing.assert_array_equal(N(found), np.isin(probe, keys))
        if mix == "q3-like":
            assert 0.005 < float(found.double().mean()) < 0.02
            assert float((p32 == -2).double().mean()) > 0.98


@pytest.mark.parametrize("fault", ["dtype", "strided"])
@pytest.mark.parametrize("at", [0, 1, 2])
def test_hash_probe_checks_name_the_tensor_at_fault(fault, at):
    """The wrapper's one test of its three inputs raises build.require's
    message for the tensor at fault, and passes good inputs."""
    from repro_torch.kernels.hash_probe import _require_int32_vectors
    good = [torch.zeros(8, dtype=torch.int32) for _ in range(3)]
    _require_int32_vectors(*good)
    bad = list(good)
    bad[at] = (torch.zeros(8, dtype=torch.int64) if fault == "dtype"
               else torch.zeros(16, dtype=torch.int32)[::2])
    name = ("probe_keys", "slots_key", "slots_row")[at]
    with pytest.raises(ValueError, match=name):
        _require_int32_vectors(*bad)


# ---------------------------------------------------------------------------
# join match + join_expand
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_probe,n_build,key_range", [
    (50, 40, 10), (1000, 300, 100), (3000, 3000, 5000), (7, 200, 3)])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_expand_matches_pallas_and_jnp(n_probe, n_build, key_range, how):
    rng = np.random.default_rng(n_probe * 13 + n_build)
    pk = rng.integers(0, key_range, n_probe).astype(np.int64)
    bk = rng.integers(0, key_range, n_build).astype(np.int64)
    order, lo, counts = join_match(T(pk), T(bk))
    j_order, j_lo, j_counts = jjoin._join_match(jnp.asarray(pk), jnp.asarray(bk))
    for a, b in ((order, j_order), (lo, j_lo), (counts, j_counts)):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    counts_out = torch.clamp(counts, min=1) if how == "left" else counts
    j_counts_out = jnp.asarray(N(counts_out))
    total = int(counts_out.sum())
    t_pad = ops.bucket_size(total)
    got = ops.join_expand(order, lo, counts, counts_out, t_pad)
    jnp_out = jjoin._join_expand(j_order, j_lo, j_counts, j_counts_out, t_pad)
    pallas = pallas_expand(j_order, j_lo, j_counts, j_counts_out, t_pad,
                           interpret=True)
    for a, b, c in zip(got, jnp_out, pallas):
        # the whole bucket, filler included: the plain version repeats the
        # jnp padding, and the Pallas kernel's search lands there too
        np.testing.assert_array_equal(N(a), np.asarray(b))
        np.testing.assert_array_equal(N(a), np.asarray(c))


def test_join_expand_no_matches():
    order, lo, counts = join_match(T(np.int64([1, 2, 3])), T(np.int64([7, 8])))
    got = ops.join_expand(order, lo, counts, counts, 8)
    want = jjoin._join_expand(*(jnp.asarray(N(x)) for x in (order, lo, counts,
                                                           counts)), 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(N(a), np.asarray(b))


def _edge_runs(case):
    """(order, lo, counts, counts_out, bucket) of the expansion edge cases."""
    rng = np.random.default_rng(len(case))
    n, nb = 300, 50
    order = rng.permutation(nb).astype(np.int64)
    lo = rng.integers(0, nb, n).astype(np.int64)
    counts = rng.integers(0, 4, n).astype(np.int64)
    if case == "all empty":
        counts[:] = 0
    elif case == "empty tail":
        counts[-40:] = 0
    elif case == "one long run":
        counts[:] = 0
        counts[123], lo[123] = 3000, 7   # past nb: the build position clips
    counts_out = np.maximum(counts, 1) if case == "left" else counts
    total = int(counts_out.sum())
    bucket = total // 3 if case == "short bucket" else jops.bucket_size(total)
    return order, lo, counts, counts_out, bucket


@pytest.mark.parametrize("case", ["all empty", "empty tail", "one long run",
                                  "left", "short bucket"])
def test_join_expand_whole_bucket_edges_match_pallas_and_jnp(case):
    """Over the whole bucket, filler included: positions past the true
    total belong to the last run in all three versions, and a bucket
    shorter than the true total cuts them alike."""
    arrays = _edge_runs(case)
    bucket = arrays[-1]
    got = ops.join_expand(*(T(a) for a in arrays[:4]), bucket)
    j_in = [jnp.asarray(a) for a in arrays[:4]]
    jnp_out = jjoin._join_expand(*j_in, bucket)
    pallas = pallas_expand(*j_in, bucket, interpret=True)
    for a, b, c in zip(got, jnp_out, pallas):
        assert N(a).shape == (bucket,)
        np.testing.assert_array_equal(N(a), np.asarray(b))
        np.testing.assert_array_equal(N(a), np.asarray(c))


# ---------------------------------------------------------------------------
# the kernels' launch shapes (pure host-side choices)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v", [1, 3, 5, 15, 16, 17, 32, 33, 100])
@pytest.mark.parametrize("g", [1, 8, 128, 4096, 12_288])
def test_groupby_column_chunk_and_lanes(v, g):
    from repro_torch.kernels import groupby_agg as ga
    cw = ga.column_chunk(v, g)
    w = ga.lane_width(cw)
    assert 1 <= cw <= min(v, ga.MAX_CHUNK)
    assert g * cw * 8 <= ga.SMEM_BUDGET           # the block partial fits
    assert w in (4, 8, 16, 32) and w >= cw and (w == 4 or w < 2 * cw)
    assert -(-v // cw) * cw >= v                  # the chunks cover V
    if v <= 32 and g * v * 8 <= ga.SMEM_BUDGET:
        assert cw == v                            # one chunk when it fits


@pytest.mark.parametrize("n", [1, 2047, 2048, 31_617, 2_000_000, 5_996_021])
@pytest.mark.parametrize("g", [1, 128, 4096])
def test_groupby_grid_blocks(n, g):
    from repro_torch.kernels import groupby_agg as ga
    sms = 132
    blocks = ga.grid_blocks(n, g, sms)
    assert 1 <= blocks <= ga.BLOCKS_PER_SM * sms
    rows = -(-n // blocks)                        # each block's slice
    assert blocks * rows >= n
    # no more blocks than slices of max(MIN_ROWS_PER_BLOCK, G) rows
    assert blocks <= -(-n // max(ga.MIN_ROWS_PER_BLOCK, g))


@pytest.mark.parametrize("v", [1, 3, 5, 8, 15, 16, 17, 32, 33, 100, 1000])
@pytest.mark.parametrize("g", [1, 128, 4096])
def test_groupby_tiles_and_shared_memory(v, g):
    """A tile of the ring: whole row steps for every warp, starts on 16-byte
    boundaries, about STAGE_BYTES; the block's shared memory within the
    card's limit at every shape the wrapper takes."""
    from repro_torch.kernels import groupby_agg as ga
    cw = ga.column_chunk(v, g)
    w = ga.lane_width(cw)
    rows = ga.tile_rows(v, w)
    step = ga.WARPS * (32 // w)
    assert rows % 4 == 0 and (rows % step == 0 or rows < step)
    assert 4 <= rows <= 8192 // w
    assert rows * (v + 1) * 4 <= ga.STAGE_BYTES or rows == 4
    part, smem = ga.smem_layout(g, cw, v, rows)
    assert part % 16 == 0 and part >= g * cw * 8
    assert smem == part + ga.STAGES * rows * (v + 1) * 4 <= ga.MAX_SMEM


def test_groupby_grid_at_the_main_path_shapes():
    from repro_torch.kernels import groupby_agg as ga
    assert ga.grid_blocks(5_996_021, 128, 132) == 264       # Q1: 2 an SM
    assert ga.grid_blocks(2_000_000, 128, 132) == 264       # ClickBench
    assert ga.grid_blocks(31_617, 4096, 132) == 8           # Q3's calls
    assert ga.lane_width(ga.column_chunk(15, 128)) == 16    # two rows a warp
    assert ga.tile_rows(15, 16) == 512 and ga.tile_rows(5, 8) == 1024
    # Q1's block: the ring and its partial leave room for 2 blocks an SM
    assert 2 * (ga.smem_layout(128, 15, 15, 512)[1] + 1024) <= 233_472


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 968_874, 5_996_021])
@pytest.mark.parametrize("total", [1, 8, 2 ** 16, 2 ** 20])
def test_join_expand_grid(n, total):
    from repro_torch.kernels import join_expand as je
    sms = 132
    tiles, helpers = je.expand_grid(n, total, sms)
    assert 1 <= tiles <= n                        # never more tiles than runs
    assert tiles * je.TILE_RUNS >= n > (tiles - 1) * je.TILE_RUNS
    assert 1 <= helpers <= je.MAX_HELPERS_PER_SM * sms
    assert helpers * je.SPAN_PER_HELPER >= total or helpers == je.MAX_HELPERS_PER_SM * sms


def test_join_expand_epochs_wrap_and_zero_the_status_words():
    """The CPU stands in for the card: a launch's epoch never repeats one
    whose status words may be left over, and the base moves only when the
    caller adds its blocks."""
    from repro_torch.kernels import join_expand as je
    ws = je._Workspace("cpu")
    status, base, epoch = ws.next_launch(5)
    assert (status.numel(), base, epoch) == (5, 0, 1)
    status.fill_(7)
    ws.base += 9
    ws.epoch = je.EPOCHS
    status, base, epoch = ws.next_launch(3)
    assert (base, epoch) == (9, 1) and not bool(status.any())


# ---------------------------------------------------------------------------
# glue and wrapper contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 100, 4097])
def test_compact_matches_reference(n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.3
    idx, count = ops.compact(T(mask))
    j_idx, j_count = jops.compact(jnp.asarray(mask))
    assert int(count) == int(j_count)
    np.testing.assert_array_equal(N(idx), np.asarray(j_idx))


def test_bucket_and_pad_match_reference():
    for n in (0, 1, 8, 9, 1000, 4097):
        assert ops.bucket_size(n) == jops.bucket_size(n)
    a = np.arange(10, dtype=np.int64).reshape(5, 2)
    np.testing.assert_array_equal(N(ops.pad_rows(T(a), 8)),
                                  np.asarray(jops.pad_rows(jnp.asarray(a), 8)))


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; any other device raises
    (a CUDA tensor would launch the kernel)."""
    x = torch.empty((4, 1), device="meta")
    lo = torch.empty(1, device="meta")
    with pytest.raises(ValueError):
        ops.filter_mask_counts(x, lo, lo)
    with pytest.raises(ValueError):
        ops.hash_probe(torch.zeros(3, dtype=torch.int32),
                       torch.empty(8, dtype=torch.int32, device="meta"),
                       torch.empty(8, dtype=torch.int32, device="meta"))


def test_plain_versions_count_no_launches():
    build.reset_launch_counts()
    rng = np.random.default_rng(0)
    ops.groupby_sum(T(rng.integers(0, 3, 50).astype(np.int32)),
                    T(rng.normal(size=(50, 2)).astype(np.float32)), 3)
    assert build.launch_counts() == {k: 0 for k in build.KERNELS}


def test_x64_reference_is_active():
    # the reference's dtype contract (int64 keys, f64 money) needs x64 on
    import repro.relational.table  # noqa: F401 — turns x64 on at import
    assert jax.config.jax_enable_x64


# ---------------------------------------------------------------------------
# the probe lowerings' plain glue (``ops.py``), against the reference's jnp
# ---------------------------------------------------------------------------


def _padded_keys(rng, n, nb, lo, hi, unique):
    keys = (rng.permutation(np.arange(lo, hi))[:n] if unique
            else rng.integers(lo, hi, n)).astype(np.int64)
    padded = np.zeros(nb, np.int64)
    padded[:n] = keys
    return padded, np.arange(nb) < n


@pytest.mark.parametrize("unique", [True, False])
def test_key_bounds_and_direct_build_lookup_match_jnp(unique):
    rng = np.random.default_rng(17)
    kp, valid = _padded_keys(rng, 300, 512, 1000, 1600, unique)
    mine = ops.key_bounds(torch.from_numpy(kp), torch.from_numpy(valid))
    want = jops.key_bounds(jnp.asarray(kp), jnp.asarray(valid))
    assert [int(x) for x in mine] == [int(x) for x in want]
    lo, domain = int(want[0]), 1024
    slot, dup = ops.direct_build(torch.from_numpy(kp), torch.from_numpy(valid),
                                 torch.tensor(lo), domain)
    jslot, jdup = jops.direct_build(jnp.asarray(kp), jnp.asarray(valid),
                                    jnp.asarray(lo), domain)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    assert bool(dup) == bool(jdup) == (not unique)
    probe = rng.integers(900, 1700, 2000).astype(np.int64)
    row, found = ops.direct_lookup(slot, torch.tensor(lo), torch.from_numpy(probe))
    jrow, jfound = jops.direct_lookup(jslot, jnp.asarray(lo), jnp.asarray(probe))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))


def test_sorted_lookup_matches_jnp():
    rng = np.random.default_rng(18)
    kp, valid = _padded_keys(rng, 300, 512, -10**12, 10**12, False)
    s, order, _, _, _ = ops.sorted_build(torch.from_numpy(kp),
                                         torch.from_numpy(valid))
    js, jorder, _, _, _ = jops.sorted_build(jnp.asarray(kp), jnp.asarray(valid))
    probe = np.concatenate([kp[:150], rng.integers(-10**12, 10**12, 500)])
    row, found = ops.sorted_lookup(s, order, torch.from_numpy(probe))
    jrow, jfound = jops.sorted_lookup(js, jorder, jnp.asarray(probe))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))


def test_factorize_and_hash_probe_int64_match_jnp():
    rng = np.random.default_rng(19)
    build_keys = rng.choice(10**15, 700, replace=False).astype(np.int64)
    probe_keys = np.concatenate([build_keys[::3],
                                 rng.integers(0, 10**15, 900)]).astype(np.int64)
    b, p = ops.factorize_keys_int32(build_keys, probe_keys)
    jb, jp = jops.factorize_keys_int32(build_keys, probe_keys)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(p, jp)
    db, dp, uni = ops.factorize_keys_int32_device(torch.from_numpy(build_keys),
                                                  torch.from_numpy(probe_keys))
    jdb, jdp, juni = jops.factorize_keys_int32_device(jnp.asarray(build_keys),
                                                      jnp.asarray(probe_keys))
    np.testing.assert_array_equal(db.numpy(), np.asarray(jdb))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(jdp))
    np.testing.assert_array_equal(uni.numpy(), np.asarray(juni))
    sk, sr, placed = ops.build_table32(torch.from_numpy(b))
    assert bool(placed)
    row, found = ops.hash_probe_int64(torch.from_numpy(p), torch.from_numpy(b),
                                      sk, sr)
    jrow, jfound = jops.hash_probe_int64(jnp.asarray(p), jnp.asarray(b),
                                         jnp.asarray(sk.numpy()),
                                         jnp.asarray(sr.numpy()))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert int(found.sum()) == len(build_keys[::3])
