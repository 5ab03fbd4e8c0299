"""The port's static-shape tier against the JAX reference, on the same
seeded inputs.

* ``StaticHashTable``: slots (keys and rows), ``all_placed`` and lookups
  equal, with roomy, tight and too-few-rounds tables; negative keys, 2^40.
* ``hash_join_bounded``: the whole padded output (filler included),
  validity and overflow equal, inner and left, single- and two-column
  keys, fitting and overflowing caps, empty sides; and no scalar pull or
  barrier for single-column keys (``tests/test_join_sync.py``'s contract).
* ``static_join_gather``; ``static_group_aggregate`` (float32 sums, equal
  within rtol 1e-6 / atol 1e-5 since the two add float32 in their own
  order; counts, presence, min and max exactly); both ``static_topk``s
  with ties (lower row first, exactly); ``core/static_ops.py``'s
  ``pack_keys``, ``local_sort_agg``, ``static_semi_join`` (and anti) and
  ``static_inner_join`` exactly.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import static_ops as ref_static_ops
from repro.exchange.service import Frame as RefFrame
from repro.relational import aggregate as ref_aggregate
from repro.relational import join as ref_join
from repro.relational import sort as ref_sort
from repro.relational.table import Table as RefTable
from repro_torch.core import instrument, static_ops
from repro_torch.exchange.service import Frame
from repro_torch.kernels import ops as kops
from repro_torch.relational import (
    StaticHashTable, static_group_aggregate,
)
from repro_torch.relational.join import (
    hash_join, hash_join_bounded, next_pow2, static_join_gather,
)
from repro_torch.relational.sort import static_topk
from repro_torch.relational.table import Table

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, err_msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=err_msg)


def _unique_keys(rng, n):
    keys = rng.choice(np.arange(-4 * n, 4 * n, dtype=np.int64), n,
                      replace=False)
    keys[: min(n, 2)] = [2**40, -(2**40)][: min(n, 2)]
    return keys


# ---------------------------------------------------------------------------
# StaticHashTable
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,capacity,max_probes", [
    (1, None, 32), (500, None, 32), (1000, 1024, 32), (1000, 1024, 3)])
def test_static_hash_table_equals_the_reference(n, capacity, max_probes):
    rng = np.random.default_rng(n + max_probes)
    keys = _unique_keys(rng, n)
    valid = rng.random(n) < 0.9
    ht = StaticHashTable.build(_t(keys), valid=_t(valid), capacity=capacity,
                               max_probes=max_probes)
    ref = ref_join.StaticHashTable.build(jnp.asarray(keys),
                                         valid=jnp.asarray(valid),
                                         capacity=capacity,
                                         max_probes=max_probes)
    assert ht.capacity == ref.capacity
    _eq(ht.slots_key, ref.slots_key, "slots_key")
    _eq(ht.slots_row, ref.slots_row, "slots_row")
    assert bool(ht.all_placed) == bool(ref.all_placed)
    probe = np.concatenate([keys, rng.integers(-8 * n, 8 * n, 2 * n)])
    row, found = ht.lookup(_t(probe))
    ref_row, ref_found = ref.lookup(jnp.asarray(probe))
    assert row.dtype == torch.int32
    _eq(row, ref_row, "row")
    _eq(found, ref_found, "found")


def test_static_hash_table_finds_every_key_and_rejects_absent_ones():
    """tests/test_relational.py::test_static_hash_table_property on a
    seeded case."""
    rng = np.random.default_rng(1)
    n = 1500
    keys = rng.choice(np.arange(4 * n, dtype=np.int64), n, replace=False)
    ht = StaticHashTable.build(_t(keys))
    assert bool(ht.all_placed)
    probe = np.concatenate([keys, keys + 4 * n])
    row, found = ht.lookup(_t(probe))
    assert found[:n].all() and not found[n:].any()
    assert (keys[row[:n].numpy()] == keys).all()


def test_next_pow2_equals_the_reference():
    for n in (0, 1, 2, 15, 16, 17, 1000, 1 << 20):
        assert next_pow2(n) == ref_join.next_pow2(n)


def test_empty_static_hash_table():
    ht = StaticHashTable.build(torch.zeros(0, dtype=torch.int64))
    assert ht.capacity == 16 and (ht.slots_key == -1).all()
    _, found = ht.lookup(_t(np.array([0, 5])))
    assert not found.any()


# ---------------------------------------------------------------------------
# hash_join_bounded
# ---------------------------------------------------------------------------


def _join_inputs(n_probe, n_build, key_range, seed, two_keys=False):
    rng = np.random.default_rng(seed)
    probe = {"k": rng.integers(-key_range, key_range, n_probe),
             "pv": rng.normal(size=n_probe).astype(np.float32),
             "s": np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n_probe)]}
    build = {"k": rng.integers(-key_range, key_range, n_build),
             "bv": rng.integers(0, 1000, n_build)}
    if two_keys:
        probe["k2"] = rng.integers(0, 3, n_probe)
        build["k2"] = rng.integers(0, 3, n_build)
    return probe, build


def _assert_bounded_equal(got, want):
    (out, valid, overflow), (r_out, r_valid, r_overflow) = got, want
    assert out.column_names == r_out.column_names
    assert out.num_rows == r_out.num_rows
    # codes, not decoded values: the filler of an empty side has no
    # dictionary entry to decode
    for name in out.column_names:
        col, r_col = out[name], r_out[name]
        assert col.kind == r_col.kind
        _eq(col.data, r_col.data, name)
        if col.dictionary is not None:
            _eq(col.dictionary, r_col.dictionary, name)
    _eq(valid, r_valid, "valid")
    assert bool(overflow) == bool(r_overflow)


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("two_keys", [False, True])
@pytest.mark.parametrize("capacity", [4096, 300, 1])
def test_hash_join_bounded_equals_the_reference(how, two_keys, capacity):
    probe, build = _join_inputs(300, 120, 40, seed=capacity + 2 * two_keys,
                                two_keys=two_keys)
    keys = ["k", "k2"] if two_keys else ["k"]
    got = hash_join_bounded(Table.from_pydict(probe), Table.from_pydict(build),
                            keys, keys, capacity, how)
    want = ref_join.hash_join_bounded(RefTable.from_pydict(probe),
                                      RefTable.from_pydict(build), keys, keys,
                                      capacity, how)
    _assert_bounded_equal(got, want)
    if capacity == 1:
        assert bool(got[2]), "a cap of 1 must overflow"


@pytest.mark.parametrize("empty", ["probe", "build", "both"])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_hash_join_bounded_empty_sides_equal_the_reference(empty, how):
    probe, build = _join_inputs(50, 20, 10, seed=9)
    if empty in ("probe", "both"):
        probe = {k: v[:0] for k, v in probe.items()}
    if empty in ("build", "both"):
        build = {k: v[:0] for k, v in build.items()}
    got = hash_join_bounded(Table.from_pydict(probe), Table.from_pydict(build),
                            ["k"], ["k"], 64, how)
    want = ref_join.hash_join_bounded(RefTable.from_pydict(probe),
                                      RefTable.from_pydict(build), ["k"],
                                      ["k"], 64, how)
    _assert_bounded_equal(got, want)


def test_hash_join_bounded_pulls_no_scalar_for_one_key():
    probe, build = _join_inputs(500, 200, 80, seed=3)
    probe, build = Table.from_pydict(probe), Table.from_pydict(build)
    syncs0 = instrument.scalar_syncs.value
    barriers0 = instrument.sync_barriers.value
    out, valid, overflow = hash_join_bounded(probe, build, ["k"], ["k"],
                                             capacity=8192, how="inner")
    assert instrument.scalar_syncs.value == syncs0
    assert instrument.sync_barriers.value == barriers0
    exact = hash_join(probe, build, ["k"], ["k"], how="inner")
    assert not bool(overflow) and int(valid.sum()) == exact.num_rows
    assert out.num_rows == kops.bucket_size(8192)


def test_static_join_gather_equals_the_reference():
    rng = np.random.default_rng(4)
    probe = {"a": rng.integers(0, 9, 40), "b": rng.normal(size=40)}
    build = {"a": rng.integers(0, 9, 12), "c": rng.integers(0, 99, 12)}
    row = rng.integers(-1, 12, 40).astype(np.int32)
    found = row >= 0
    got, gf = static_join_gather({k: _t(v) for k, v in probe.items()},
                                 {k: _t(v) for k, v in build.items()},
                                 _t(row), _t(found))
    want, wf = ref_join.static_join_gather(
        {k: jnp.asarray(v) for k, v in probe.items()},
        {k: jnp.asarray(v) for k, v in build.items()},
        jnp.asarray(row), jnp.asarray(found))
    assert list(got) == list(want)
    for k in got:
        _eq(got[k], want[k], k)
    _eq(gf, wf)


# ---------------------------------------------------------------------------
# static_group_aggregate, static_topk
# ---------------------------------------------------------------------------


def test_static_group_aggregate_equals_the_reference():
    rng = np.random.default_rng(6)
    n, g = 400, 12
    gids = rng.integers(0, g - 1, n)          # group g-1: no rows at all
    gids[:5] = 3
    valid = rng.random(n) < 0.8
    valid[gids == 3] = False                   # group 3: invalid rows only
    data = rng.normal(size=n).astype(np.float32)
    ints = rng.integers(-50, 50, n)
    values = {"s": ("sum", data), "a": ("avg", data), "c": ("count", data),
              "lo": ("min", data), "hi": ("max", data),
              "ilo": ("min", ints), "ihi": ("max", ints)}
    got = static_group_aggregate(_t(gids), _t(valid),
                                 {k: (f, _t(v)) for k, (f, v) in values.items()},
                                 g)
    want = ref_aggregate.static_group_aggregate(
        jnp.asarray(gids), jnp.asarray(valid),
        {k: (f, jnp.asarray(v)) for k, (f, v) in values.items()}, g)
    assert set(got) == set(want)
    for k in got:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        if k in ("s", "a"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5, err_msg=k)
        else:
            _eq(a, b, k)


@pytest.mark.parametrize("dtype", ["int64", "float64", "float32"])
def test_static_topk_keeps_the_reference_order_with_ties(dtype):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 6, 200).astype(dtype)     # heavy ties
    valid = rng.random(200) < 0.85
    for k in (1, 10, 60):
        idx, vout = static_topk(_t(keys), _t(valid), k)
        ridx, rvout = ref_sort.static_topk(jnp.asarray(keys),
                                           jnp.asarray(valid), k)
        _eq(idx, ridx, f"k={k}")
        _eq(vout, rvout, f"k={k}")


# ---------------------------------------------------------------------------
# core/static_ops.py
# ---------------------------------------------------------------------------


def _frames(cols, valid):
    return (Frame({k: _t(v) for k, v in cols.items()}, _t(valid)),
            RefFrame({k: jnp.asarray(v) for k, v in cols.items()},
                     jnp.asarray(valid)))


def _eq_frames(got, want):
    assert list(got.columns) == list(want.columns)
    for k in got.columns:
        _eq(got.columns[k], want.columns[k], k)
    _eq(got.valid, want.valid, "valid")


def test_pack_keys_equals_the_reference():
    rng = np.random.default_rng(8)
    cols = [rng.integers(0, c, 50) for c in (7, 13, 5)]
    _eq(static_ops.pack_keys([_t(c) for c in cols], [7, 13, 5]),
        ref_static_ops.pack_keys([jnp.asarray(c) for c in cols], [7, 13, 5]))


def test_local_sort_agg_static():
    """tests/test_distributed.py::test_local_sort_agg_static on the port."""
    key = _t(np.array([5, 3, 5, 3, 9, 1, 5, 0], np.int64))
    val = _t(np.array([1.0, 2, 3, 4, 5, 6, 7, 0]))
    valid = _t(np.array([1, 1, 1, 1, 1, 1, 1, 0], bool))
    out, _ = static_ops.local_sort_agg(Frame({"v": val}, valid), key,
                                       sums={"s": val})
    k = out.columns["key"][out.valid].tolist()
    s = out.columns["s"][out.valid].tolist()
    assert dict(zip(k, s)) == {1: 6.0, 3: 6.0, 5: 11.0, 9: 5.0}


def test_local_sort_agg_equals_the_reference():
    rng = np.random.default_rng(9)
    n = 256
    key = rng.integers(-20, 20, n)
    firsts = (key * 3).astype(np.int32)        # one value per key
    cols = {"v": rng.integers(-100, 100, n).astype(np.float64),
            "f": firsts}
    valid = rng.random(n) < 0.7
    fr, rfr = _frames(cols, valid)
    got, gk = static_ops.local_sort_agg(fr, _t(key), {"s": fr.columns["v"]},
                                        {"f": fr.columns["f"]})
    want, wk = ref_static_ops.local_sort_agg(
        rfr, jnp.asarray(key), {"s": rfr.columns["v"]}, {"f": rfr.columns["f"]})
    _eq_frames(got, want)
    _eq(gk, wk)


@pytest.mark.parametrize("anti", [False, True])
def test_static_semi_join_equals_the_reference(anti):
    rng = np.random.default_rng(10)
    bkeys = _unique_keys(rng, 60)
    bvalid = rng.random(60) < 0.8
    probe_key = rng.integers(-240, 240, 300)
    probe_key[:30] = bkeys[:30]
    fr, rfr = _frames({"x": rng.normal(size=300)}, rng.random(300) < 0.9)
    got = static_ops.static_semi_join(fr, _t(probe_key), _t(bkeys),
                                      _t(bvalid), anti=anti)
    want = ref_static_ops.static_semi_join(
        rfr, jnp.asarray(probe_key), jnp.asarray(bkeys), jnp.asarray(bvalid),
        anti=anti)
    _eq_frames(got, want)


def test_static_inner_join_equals_the_reference():
    rng = np.random.default_rng(11)
    bkeys = _unique_keys(rng, 80)
    build, rbuild = _frames({"bk": bkeys, "bval": rng.integers(0, 9, 80)},
                            rng.random(80) < 0.85)
    probe_key = bkeys[rng.integers(0, 80, 200)]
    probe_key[::7] += 1000                     # some misses
    probe, rprobe = _frames({"pk": probe_key, "pval": rng.normal(size=200)},
                            rng.random(200) < 0.9)
    got = static_ops.static_inner_join(probe, probe.columns["pk"], build,
                                       build.columns["bk"])
    want = ref_static_ops.static_inner_join(rprobe, rprobe.columns["pk"],
                                            rbuild, rbuild.columns["bk"])
    _eq_frames(got, want)


@pytest.mark.parametrize("descending", [True, False])
def test_static_ops_topk_keeps_the_reference_order_with_ties(descending):
    rng = np.random.default_rng(12)
    score = rng.integers(0, 5, 120).astype(np.float64)   # heavy ties
    fr, rfr = _frames({"score": score, "row": np.arange(120)},
                      rng.random(120) < 0.8)
    for k in (1, 7, 40):
        got = static_ops.static_topk(fr, fr.columns["score"], k, descending)
        want = ref_static_ops.static_topk(rfr, rfr.columns["score"], k,
                                          descending)
        _eq_frames(got, want)
