"""The port's exchange layer against the JAX reference.

* The hash functions agree bit for bit (``partition_hash`` on tensors,
  ``np_partition_hash`` on the host, the static hash table's ``_hash`` and
  the Bloom filter's bits) on keys with negatives, 2^40 and the int64
  extremes, for 2, 3, 7, 8 and 16 partitions.
* Every collective of ``exchange/service.py`` and ``exchange/bloom.py`` on
  8 logical shards equals the reference's ``shard_map`` on 8 forced host
  devices (``tests/_torch_dist_ref_worker.py``, one subprocess for the
  module): received buffers, validity and overflow, an overflowing case
  included, exactly; but ``shuffle_hierarchical``'s overflow is the whole
  mesh's (a plain count), where the reference's misses rows dropped
  outside a shard's own pod and data groups.
* ``place_exchanges`` + ``cut_fragments`` + ``explain_placed`` on the 22
  TPC-H and 15 ClickBench plans at 1, 2, 4 and 8 shards give the
  reference's fragments: ids, kinds, keys, placements, deps, ``run_once``,
  ``pt``, and fragment plan JSON byte for byte.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ref_worker as ref_worker
from repro.core.distributed import _DbCatalog as RefDbCatalog
from repro.core.distributed import np_partition_hash as ref_np_partition_hash
from repro.core.plan import plan_to_json as ref_plan_to_json
from repro.data import clickbench as ref_cb
from repro.data.tpch import generate as ref_generate
from repro.data.tpch_queries import QUERIES as REF_QUERIES
from repro.exchange import bloom as ref_bloom
from repro.exchange.service import partition_hash as ref_partition_hash
from repro.optimizer import exchange as ref_exchange
from repro.relational.join import _hash as ref_hash
from repro.sql import sql_to_plan as ref_sql_to_plan
from repro_torch.core.distributed import (
    DistributedEngine, _DbCatalog, np_partition_hash,
)
from repro_torch.core.plan import plan_to_json
from repro_torch.data import clickbench as cb
from repro_torch.data.tpch_queries import QUERIES
from repro_torch.exchange import bloom
from repro_torch.exchange.service import (
    Frame, ShardMesh, all_reduce_sum, broadcast, collective_step, merge,
    multicast, partition_hash, shuffle, shuffle_by_dest, shuffle_hierarchical,
)
from repro_torch.optimizer import exchange
from repro_torch.relational.join import _hash
from repro_torch.sql import sql_to_plan

torch.set_num_threads(1)

N_SHARDS, CAP = 8, 64
KEYS = np.array([0, 1, 2, 7, 123456789, 2**40, -5, -1, 999983, -(2**40),
                 np.iinfo(np.int64).max, np.iinfo(np.int64).min,
                 np.iinfo(np.int64).min + 1, np.iinfo(np.int64).max - 1,
                 2**31, -(2**31) - 1], np.int64)


# ---------------------------------------------------------------------------
# hash functions, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 7, 8, 16])
def test_partition_hashes_agree_bit_for_bit(n):
    rng = np.random.default_rng(n)
    keys = np.concatenate([KEYS, rng.integers(np.iinfo(np.int64).min,
                                              np.iinfo(np.int64).max, 4096,
                                              dtype=np.int64)])
    want = np.asarray(ref_partition_hash(jnp.asarray(keys), n))
    assert want.dtype == np.int32
    got = partition_hash(torch.from_numpy(keys), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np_partition_hash(keys, n), want)
    np.testing.assert_array_equal(ref_np_partition_hash(keys, n), want)


@pytest.mark.parametrize("n", [2, 3, 7, 8, 16])
def test_static_table_hash_agrees_bit_for_bit(n):
    mask = (1 << (n + 3)) - 1
    want = np.asarray(ref_hash(jnp.asarray(KEYS), mask))
    got = _hash(torch.from_numpy(KEYS), mask)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m_bits", [61, 1 << 10])
def test_bloom_bits_agree_bit_for_bit(m_bits):
    rng = np.random.default_rng(m_bits)
    keys = np.concatenate([KEYS, rng.integers(-(10**12), 10**12, 300)])
    valid = rng.random(keys.shape[0]) < 0.7
    want = np.asarray(ref_bloom.bloom_build(jnp.asarray(keys),
                                            jnp.asarray(valid), m_bits))
    got = bloom.bloom_build(torch.from_numpy(keys), torch.from_numpy(valid),
                            m_bits)
    np.testing.assert_array_equal(got.numpy(), want)
    probe = np.concatenate([keys, rng.integers(-(10**12), 10**12, 300)])
    np.testing.assert_array_equal(
        bloom.bloom_maybe_contains(got, torch.from_numpy(probe)).numpy(),
        np.asarray(ref_bloom.bloom_maybe_contains(jnp.asarray(want),
                                                  jnp.asarray(probe))))


def test_bloom_filter_properties():
    """tests/test_distributed.py::test_bloom_filter_properties on the port."""
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.choice(10**9, 5000, replace=False))
    valid = torch.ones(5000, dtype=torch.bool)
    bits = bloom.bloom_build(keys, valid, 1 << 16)
    # no false negatives
    assert bool(bloom.bloom_maybe_contains(bits, keys).all())
    # low false-positive rate on absent keys
    absent = torch.from_numpy(rng.integers(2 * 10**9, 3 * 10**9, 5000))
    fp = float(bloom.bloom_maybe_contains(bits, absent).float().mean())
    assert fp < 0.05, fp


# ---------------------------------------------------------------------------
# collectives on 8 shards against shard_map on 8 host devices
# ---------------------------------------------------------------------------

OUT_CAPS = (128, 4)                 # every bucket fits / most overflow
GROUP_SIZES = (2, 4, 3)             # 3 does not divide the mesh
HIER_CAPS = ((64, 128), (16, 16))   # fits / both stages overflow
BLOOM_M_BITS, BLOOM_K = 256, 3


def _inputs():
    rng = np.random.default_rng(20)
    n = N_SHARDS * CAP
    keys = rng.integers(-(2**40), 2**40, n)
    keys[: KEYS.shape[0]] = KEYS
    return {
        "cols": {"k": keys, "v": rng.normal(size=n),
                 "m": rng.integers(-1000, 1000, (n, 3)).astype(np.int32)},
        "valid": rng.random(n) < 0.8,
        "dest": rng.integers(0, N_SHARDS, n).astype(np.int32),
        "keys": keys,
        "counts": rng.integers(0, 1000, N_SHARDS),
        "out_caps": OUT_CAPS, "group_sizes": GROUP_SIZES,
        "hier_caps": HIER_CAPS,
        "bloom_m_bits": BLOOM_M_BITS, "bloom_k": BLOOM_K,
        "bloom_probe": rng.integers(-(2**40), 2**40, 2000),
    }


@pytest.fixture(scope="module")
def collectives():
    """(inputs, the reference's outputs)."""
    inp = _inputs()
    return inp, ref_worker.run("exchange", inp)


def _sharded(inp):
    cols = {k: torch.from_numpy(v.reshape((N_SHARDS, CAP) + v.shape[1:]))
            for k, v in inp["cols"].items()}
    return Frame(cols, torch.from_numpy(inp["valid"].reshape(N_SHARDS, CAP)))


def _flat(t):
    return t.reshape((-1,) + tuple(t.shape[2:])).numpy()


def _assert_frame(got: Frame, want_cols, want_valid, overflow=None,
                  want_overflow=None):
    np.testing.assert_array_equal(_flat(got.valid), want_valid)
    assert set(got.columns) == set(want_cols)
    for name, col in got.columns.items():
        np.testing.assert_array_equal(_flat(col), want_cols[name], err_msg=name)
    if want_overflow is not None:
        np.testing.assert_array_equal(overflow.numpy(), want_overflow)


@pytest.mark.parametrize("out_cap", OUT_CAPS)
def test_shuffle_by_dest_and_shuffle_equal_the_reference(collectives, out_cap):
    inp, ref = collectives
    mesh = ShardMesh.of(N_SHARDS, "cpu")
    dest = torch.from_numpy(inp["dest"].reshape(N_SHARDS, CAP))
    got, ov = shuffle_by_dest(_sharded(inp), dest, mesh, out_cap)
    _assert_frame(got, *ref[("shuffle_by_dest", out_cap)][:2], ov,
                  ref[("shuffle_by_dest", out_cap)][2])
    keys = torch.from_numpy(inp["keys"].reshape(N_SHARDS, CAP))
    got, ov = shuffle(_sharded(inp), keys, mesh, out_cap)
    _assert_frame(got, *ref[("shuffle", out_cap)][:2], ov,
                  ref[("shuffle", out_cap)][2])
    # the overflowing case really overflows, and the fitting one does not
    assert (int(ov[0]) > 0) == (out_cap < CAP)


def test_broadcast_merge_multicast_equal_the_reference(collectives):
    inp, ref = collectives
    mesh = ShardMesh.of(N_SHARDS, "cpu")
    _assert_frame(broadcast(_sharded(inp), mesh), *ref["broadcast"])
    _assert_frame(merge(_sharded(inp), mesh), *ref["merge"])
    for g in GROUP_SIZES:
        _assert_frame(multicast(_sharded(inp), mesh, g), *ref[("multicast", g)])


def test_all_reduce_sum_equals_the_reference(collectives):
    inp, ref = collectives
    got = all_reduce_sum(torch.from_numpy(inp["counts"]),
                         ShardMesh.of(N_SHARDS, "cpu"))
    np.testing.assert_array_equal(got.numpy(), ref["all_reduce_sum"])


def _hierarchical_overflow(inp, caps, pods=2, data=4) -> int:
    """Rows past their buckets in both stages of the pod-aware shuffle,
    counted over every shard, plainly: a stage keeps each (shard,
    destination) group's first rows, in row order."""
    g = ref_np_partition_hash(inp["cols"]["k"], pods * data).reshape(
        pods * data, CAP)
    valid = inp["valid"].reshape(pods * data, CAP)
    over, arrived = 0, [[] for _ in range(pods * data)]
    for s in range(pods * data):
        for q in range(pods):
            rows = np.flatnonzero(valid[s] & (g[s] // data == q))
            over += max(len(rows) - caps[0], 0)
            arrived[q * data + s % data] += list(g[s, rows[:caps[0]]] % data)
    for got in arrived:
        over += int(np.maximum(np.bincount(got, minlength=data) - caps[1],
                               0).sum())
    return over


@pytest.mark.parametrize("caps", HIER_CAPS)
def test_shuffle_hierarchical_equals_the_reference(collectives, caps):
    """Frames equal the reference's; the overflow is the whole mesh's count
    on every shard, where the reference's shard sees only the rows dropped
    in its own pod and data groups (ROADMAP queue 3)."""
    inp, ref = collectives
    mesh = ShardMesh((("pod", 2), ("data", 4)), torch.device("cpu"))
    got, ov = shuffle_hierarchical(_sharded(inp), "k", mesh, "pod", "data",
                                   *caps)
    want = ref[("shuffle_hierarchical", caps)]
    _assert_frame(got, *want[:2])
    total = _hierarchical_overflow(inp, caps)
    np.testing.assert_array_equal(ov.numpy(), np.full(N_SHARDS, total))
    assert (total > 0) == (caps == (16, 16))
    if total:
        assert (want[2] < total).all()
    else:
        assert (want[2] == 0).all()


def test_bloom_across_shards_equals_the_reference(collectives):
    inp, ref = collectives
    mesh = ShardMesh.of(N_SHARDS, "cpu")
    fr = _sharded(inp)
    local = bloom.bloom_build(fr.columns["k"], fr.valid, BLOOM_M_BITS, BLOOM_K)
    np.testing.assert_array_equal(local.reshape(-1).numpy(), ref["bloom_local"])
    combined = bloom.bloom_or_across(local, mesh, ["data"])
    np.testing.assert_array_equal(combined.reshape(-1).numpy(),
                                  ref["bloom_combined"])
    np.testing.assert_array_equal(
        bloom.bloom_maybe_contains(combined[0], torch.from_numpy(
            inp["bloom_probe"]), BLOOM_K).numpy(), ref["bloom_contains"])


def test_collective_step_journals_a_collective_span():
    from repro_torch.observability.journal import JOURNAL
    mesh = ShardMesh.of(4, "cpu")
    step = collective_step(lambda x: x + 1, mesh, label="shuffle")
    assert step(1) == 2                      # outside a query: no span
    with JOURNAL.query_span("q.test") as q:
        assert step(2) == 3
    evs = [e for e in JOURNAL.events(q.query_id) if e["cat"] == "collective"]
    assert [e["name"] for e in evs] == ["collective:shuffle"]
    assert evs[0]["attrs"]["shards"] == 4
    assert collective_step(len, mesh) is len  # no label: the step itself


# ---------------------------------------------------------------------------
# exchange placement and fragment cutting, byte for byte
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plan_db():
    """(TPC-H host db, ClickBench host db, ClickBench catalogs)."""
    n_rows = 2000
    return (ref_generate(0.002), ref_cb.generate(n_rows),
            (cb.clickbench_catalog(n_rows), ref_cb.clickbench_catalog(n_rows)))


def _parts(db, partitioning, hash_kind, rep_kind):
    keys = DistributedEngine.PARTITION_KEYS
    return {t: (partitioning(hash_kind, keys[t]) if keys.get(t) in cols
                else partitioning(rep_kind)) for t, cols in db.items()}


def _fragment_rows(frags, to_json):
    return [(f.fid, f.label, f.kind, list(f.keys), f.placement, f.run_once,
             tuple(f.pt) if f.pt else None, list(f.deps), f.rel_count,
             to_json(f.plan)) for f in frags]


def _placed(db, plan, ref_plan, n):
    got = exchange.cut_fragments(exchange.place_exchanges(
        plan, _DbCatalog(db), n,
        _parts(db, exchange.Partitioning, exchange.HASH, exchange.REP)))
    want = ref_exchange.cut_fragments(ref_exchange.place_exchanges(
        ref_plan, RefDbCatalog(db), n,
        _parts(db, ref_exchange.Partitioning, ref_exchange.HASH,
               ref_exchange.REP)))
    return got, want


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_tpch_placement_equals_the_reference(plan_db, qid, n):
    db = plan_db[0]
    got, want = _placed(db, QUERIES[qid](), REF_QUERIES[qid](), n)
    assert _fragment_rows(got, plan_to_json) == \
        _fragment_rows(want, ref_plan_to_json)
    assert exchange.explain_placed(got) == ref_exchange.explain_placed(want)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("qid", sorted(cb.CLICKBENCH_QUERIES))
def test_clickbench_placement_equals_the_reference(plan_db, qid, n):
    _, db, (cat, ref_cat) = plan_db
    sql = cb.CLICKBENCH_QUERIES[qid]
    got, want = _placed(db, sql_to_plan(sql, catalog=cat),
                        ref_sql_to_plan(sql, catalog=ref_cat), n)
    assert _fragment_rows(got, plan_to_json) == \
        _fragment_rows(want, ref_plan_to_json)
    assert exchange.explain_placed(got) == ref_exchange.explain_placed(want)


def test_placement_exchanges_at_two_shards_and_up(plan_db):
    """The cases above are not vacuous: at 1 shard Q3 still cuts, and at
    8 shards the TPC-H set uses all three exchange kinds."""
    db = plan_db[0]
    kinds = set()
    for qid in QUERIES:
        got, _ = _placed(db, QUERIES[qid](), REF_QUERIES[qid](), 8)
        kinds |= {f.kind for f in got if f.kind}
    assert kinds == {"shuffle", "broadcast", "merge"}
    got, _ = _placed(db, QUERIES[3](), REF_QUERIES[3](), 1)
    assert len(got) >= 2
