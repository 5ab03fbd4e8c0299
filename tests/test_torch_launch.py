"""The port's ``launch/`` (the SQL half of the dry run) against the JAX
reference, on the CPU.

* The five SQL fragments (``q1``, ``q3``, ``q3pt``, ``q3c``, ``q3ptc``) on
  an 8-shard ``(8,)`` and a ``(2, 4)`` mesh at SF0.01, on seeded data in
  dbgen's domains, against the reference's jitted ``shard_map`` fragments
  on 8 forced host devices (``tests/_torch_launch_ref_worker.py``, one
  subprocess for the module): keys, dates, priorities, validity and
  overflow exactly; Q3's revenue within rtol 1e-12 (the same float32 line
  revenues summed in float64 in another order: at most 7 terms an order);
  Q1's float32 sums within ``rows x 2^-23`` of each other, ``rows`` the
  most rows a (shard, group) sums (both add float32 in row order, each
  addition rounding by at most 2^-24 of the running sum); collective
  bytes by kind equal to ``collective_bytes`` of the compiled HLO, counted
  both on CPU tensors and by the dry run on fake CUDA tensors.
* On lines skewed onto one order key, both meshes overflow: the flat
  shuffle's count equals the reference's; the pod-aware one's is the
  whole mesh's, where the reference's shard 0 sees only part of it
  (ROADMAP queue 3).  Both equal the plain count of ``sql_data.py``.
* Every fragment against the plain global answer (``sql_data.py``), as
  ``chip_smoke.py`` phase 5e holds them on the card.
* ``extra`` at the reference's own SF100 on 256 and 2 x 256 shards; the
  dry-run CLI's sweep of the SQL cells: ten records with the reference's
  caps; a model cell's record (``tests/test_torch_launch_models.py``
  holds the model cells against the reference).
* Units: ``CountingMesh``'s bytes by kind, ``OpCounter``'s traffic,
  element operations and peak, the indexing routes of ``fake_cuda``, the
  static tier on sharded frames against one shard at a time, and
  fixed-point sums of several columns.
"""
import json
from pathlib import Path

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import _torch_launch_ref_worker as ref_worker
from repro_torch.core import static_ops
from repro_torch.exchange.service import Frame, ShardMesh
from repro_torch.launch import analysis, dryrun, mesh as launch_mesh
from repro_torch.launch import sql_data, sql_dryrun
from repro_torch.relational.aggregate import fixed_point_segment_sum

torch.set_num_threads(1)

SF_SMALL = 0.01
SEED = 19920101
SHAPES = sql_dryrun.SHAPES
MESHES = (False, True)
CASES = [(s, mp) for s in SHAPES for mp in MESHES]


def _mesh(multi_pod: bool) -> ShardMesh:
    if multi_pod:
        return ShardMesh((("pod", 2), ("data", 4)), torch.device("cpu"))
    return ShardMesh.of(8, "cpu")


def _build(shape, multi_pod):
    return sql_dryrun.lower_sql_fragment(shape, multi_pod, sf=SF_SMALL,
                                         mesh=_mesh(multi_pod))


def _data(shape, extra, skew=False):
    if shape == "q1":
        return sql_data.q1_data(extra, SF_SMALL, SEED, device="cpu")
    data = sql_data.q3_data(extra, SF_SMALL, SEED, compress="c" in shape,
                            device="cpu")
    if skew:   # every line on one order, which hashes to the last shard
        keys = data[2]["o_orderkey"][data[3]]
        key = keys[sql_data._dest(keys, extra["n_shards"])
                   == extra["n_shards"] - 1][0]
        lcols = dict(data[0])
        lcols["l_orderkey"] = torch.full_like(lcols["l_orderkey"], int(key))
        data = (lcols,) + data[1:]
    return data


def _numpy(tree):
    """The reference's arguments: global, shard-major numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy(v) for v in tree)
    return tree.reshape(-1).numpy()


@pytest.fixture(scope="module")
def port_cases():
    out = {}
    for shape, mp in CASES:
        fn, specs, extra = _build(shape, mp)
        out[(shape, mp, "seeded")] = (fn, extra, _data(shape, extra))
    for mp in MESHES:
        fn, specs, extra = _build("q3", mp)
        out[("q3", mp, "skewed")] = (fn, extra, _data("q3", extra, skew=True))
    return out


@pytest.fixture(scope="module")
def ref(port_cases):
    cases = {k: _numpy(v[2]) for k, v in port_cases.items()}
    return ref_worker.run({"sf": SF_SMALL, "cases": cases})


# ---------------------------------------------------------------------------
# the fragments against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,multi_pod", CASES)
def test_extra_at_sf100_equals_the_reference(shape, multi_pod, ref):
    _, specs, extra = sql_dryrun.lower_sql_fragment(shape, multi_pod)
    want = ref["extras"][(shape, multi_pod)]
    for key, value in want.items():
        assert extra[key] == value, key
    assert extra["n_shards"] == (512 if multi_pod else 256)
    assert extra["sf"] == 100 and extra["kind"] == "sql-fragment"
    leaves = torch.utils._pytree.tree_leaves(specs)
    assert all(s.shape[0] == extra["n_shards"] for s in leaves)


@pytest.mark.parametrize("shape,multi_pod", CASES)
def test_fragment_outputs_equal_the_reference(shape, multi_pod, port_cases,
                                              ref):
    fn, extra, data = port_cases[(shape, multi_pod, "seeded")]
    want = ref["runs"][(shape, multi_pod, "seeded")]
    assert {k: v for k, v in want["extra"].items()} == {
        k: v for k, v in extra.items() if k in want["extra"]}
    got = fn(_mesh(multi_pod), *data)
    if shape == "q1":
        cols, valid = data
        mask = valid & (cols["l_shipdate"] <= sql_dryrun.Q1_CUTOFF)
        gid = cols["l_returnflag"] * 3 + cols["l_linestatus"]
        rows = max(int(((gid == g) & mask).sum(1).max()) for g in range(9))
        np.testing.assert_allclose(got.numpy(), want["outputs"],
                                   rtol=rows * 2.0 ** -23, atol=0)
        assert got.dtype == torch.float32 and got.shape == (9, 6)
        return
    key, revenue, odate, prio, valid, ov = got
    w_key, w_rev, w_date, w_prio, w_valid, w_ov = want["outputs"]
    np.testing.assert_array_equal(valid.reshape(-1).numpy(), w_valid)
    np.testing.assert_array_equal(key.reshape(-1).numpy(), w_key)
    np.testing.assert_array_equal(odate.reshape(-1).numpy(), w_date)
    np.testing.assert_array_equal(prio.reshape(-1).numpy(), w_prio)
    np.testing.assert_allclose(revenue.reshape(-1).numpy(), w_rev,
                               rtol=1e-12, atol=0)
    assert int(ov) == int(w_ov) == 0
    assert int(valid.sum()) == 10 * extra["n_shards"]
    assert revenue.dtype == torch.float64 and odate.dtype == torch.int32


@pytest.mark.parametrize("shape,multi_pod", CASES)
def test_collective_bytes_equal_the_reference(shape, multi_pod, port_cases,
                                              ref):
    fn, extra, data = port_cases[(shape, multi_pod, "seeded")]
    want = dict(ref["runs"][(shape, multi_pod, "seeded")]["collectives"])
    assert want.pop("loops_detected") in (0.0, 1.0)
    counting = analysis.CountingMesh.like(_mesh(multi_pod))
    fn(counting, *data)
    assert counting.collective_bytes() == want
    # the dry run counts the same on fake CUDA tensors
    fn, specs, _ = _build(shape, multi_pod)
    record = dryrun.analyze(fn, specs, _mesh(multi_pod))
    assert record["collective_bytes_per_device"] == want


@pytest.mark.parametrize("multi_pod", MESHES)
def test_overflow_counts_the_whole_mesh(multi_pod, port_cases, ref):
    fn, extra, data = port_cases[("q3", multi_pod, "skewed")]
    *_, ov = fn(_mesh(multi_pod), *data)
    plain = sql_data.plain_q3(data, extra, 2 if multi_pod else 1, False)
    w_ov = int(ref["runs"][("q3", multi_pod, "skewed")]["outputs"][5])
    assert int(ov) == plain["overflow"] > 0
    if multi_pod:
        # the reference's shard 0 sums each stage along its own axis only:
        # the lines overflow in the second pod, which it does not see
        assert w_ov == 0
    else:
        assert w_ov == plain["overflow"]


# ---------------------------------------------------------------------------
# the fragments against the plain global answer (phase 5e's checks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,multi_pod", CASES)
def test_fragment_holds_against_the_plain_answer(shape, multi_pod,
                                                 port_cases):
    fn, extra, data = port_cases[(shape, multi_pod, "seeded")]
    got = fn(_mesh(multi_pod), *data)
    if shape == "q1":
        # float32 sums in row order here: each addition rounds by at most
        # 2^-24 of the running sum, over at most ~1,900 rows a (shard,
        # group), then the psum's 8 terms
        sql_data.hold_q1(got, sql_data.plain_q1(*data), rtol=2000 * 2.0 ** -24)
        return
    plain = sql_data.plain_q3(data, extra, 2 if multi_pod else 1,
                              "pt" in shape)
    assert int(got[-1]) == plain["overflow"] == 0
    if "pt" in shape:
        assert 0.0 < plain["bloom_pass"] < 0.05
    # two float32 roundings a line revenue (three when the discount is a
    # code), summed in float64
    sql_data.hold_q3(got, plain, extra["n_shards"], rtol=4 * 2.0 ** -24)


def test_hold_q3_catches_a_wrong_answer(port_cases):
    fn, extra, data = port_cases[("q3", False, "seeded")]
    got = list(fn(_mesh(False), *data))
    plain = sql_data.plain_q3(data, extra, 1, False)
    sql_data.hold_q3(got, plain, extra["n_shards"], rtol=4 * 2.0 ** -24)
    got[1] = got[1].clone()
    got[1][3, 0] *= 1 + 1e-6
    with pytest.raises(AssertionError, match="shard 3: revenue"):
        sql_data.hold_q3(got, plain, extra["n_shards"], rtol=4 * 2.0 ** -24)
    got[1][3, 0] /= 1 + 1e-6
    got[0] = got[0].clone()
    got[0][5, [0, 1]] = got[0][5, [1, 0]]
    with pytest.raises(AssertionError, match="shard 5"):
        sql_data.hold_q3(got, plain, extra["n_shards"], rtol=4 * 2.0 ** -24)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


RECORD_KEYS = {"arch", "shape", "mesh", "status", "kind", "sf", "n_shards",
               "bytes_accessed_per_device", "element_ops_per_device",
               "collective_bytes_per_device", "memory", "n_chips"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "resident_bytes_per_chip", "fits_card", "card_bytes", "card"}


def test_dryrun_sweep_writes_every_cell(tmp_path, ref):
    assert dryrun.main(["--sweep", "--arch", dryrun.SQL_ARCH, "--jobs", "1",
                        "--outdir", str(tmp_path)]) == 0
    records = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    sql = [r for r in records if r["arch"] == dryrun.SQL_ARCH]
    assert len(sql) == 10
    for r in sql:
        assert RECORD_KEYS <= set(r) and MEMORY_KEYS <= set(r["memory"])
        assert r["status"] == "ok" and r["sf"] == 100
        multi_pod = r["mesh"] == "2x256"
        shape = r["shape"].split("_")[0]
        want = ref["extras"][(shape, multi_pod)]
        assert r["n_shards"] == r["n_chips"] == want["n_shards"]
        for key in ("caps", "cap", "shuffle_out_caps"):
            if key in want:
                assert r[key] == want[key]
        coll = r["collective_bytes_per_device"]
        assert coll["total"] == sum(v for k, v in coll.items()
                                    if k != "total") > 0
        mem = r["memory"]
        assert mem["resident_bytes_per_chip"] > mem["argument_bytes"] > 0
        assert mem["card_bytes"] == dryrun.STATED_CARD_BYTES
    assert len(records) == 10          # --arch keeps the sweep to the SQL


MODEL_KEYS = {"arch", "shape", "mesh", "status", "model_params",
              "active_params", "seq_len", "global_batch", "kind",
              "flops_per_device", "flops_detail", "bytes_accessed_per_device",
              "collective_bytes_per_device", "memory", "n_chips"}


def test_model_cell_record_is_ok_with_the_reference_keys():
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", True)
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert MODEL_KEYS <= set(rec) and MEMORY_KEYS <= set(rec["memory"])
    assert rec["n_chips"] == 512 and rec["kind"] == "decode"
    assert rec["seq_len"] == 32_768 and rec["global_batch"] == 128
    assert set(rec["flops_detail"]) >= {"cost_analysis_flops",
                                        "dot_flops_loop_corrected", "flops"}
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total") > 0
    mem = rec["memory"]
    assert mem["resident_bytes_per_chip"] > mem["argument_bytes"] > 0
    assert mem["fits_card"] and mem["card_bytes"] == dryrun.STATED_CARD_BYTES


def test_dryrun_cli_writes_a_record(tmp_path):
    assert dryrun.main(["--arch", dryrun.SQL_ARCH, "--shape", "q1_sf100",
                        "--mesh", "pod", "--outdir", str(tmp_path)]) == 0
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert path.name == "sirius-tpch__q1_sf100__256.json"
    assert RECORD_KEYS <= set(rec) and rec["cap"] == 2_344_320
    # Q1's psum of a (9, 6) float32 partial: 216 bytes, counted double
    assert rec["collective_bytes_per_device"] == {"all-reduce": 432.0,
                                                  "total": 432.0}
    assert rec["memory"]["output_bytes"] == 216
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--mesh", "pod", "--outdir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-4b__train_4k__16x16.json").read_text())
    assert rec["status"] == "ok" and rec["kind"] == "train"


GOLDEN_MODELS = Path(__file__).parent / "golden" / "dryrun_models_pod.json"


@pytest.mark.parametrize(
    "cell", sorted(json.loads(GOLDEN_MODELS.read_text())["cells"]))
def test_phase_6e_golden_counts_equal_this_run(cell):
    """``chip_smoke.py`` phase 6e holds the card's dry run of these cells to
    this file; it must be this tree's counts.  Regenerate it with
    ``python -c "import json, torch, chip_smoke as cs; from
    repro_torch.launch import dryrun, model_dryrun as md; json.dump({'torch':
    torch.__version__.split('+')[0], 'cells': {f'{a} {s}':
    md.counts(dryrun.model_record(a, s, False)) for a, s in
    cs.MODEL_DRY_CELLS}}, open(cs.MODEL_DRY_GOLDEN, 'w'), indent=1,
    sort_keys=True)"`` (``PYTHONPATH=src`` from the repository's root)."""
    from repro_torch.launch import model_dryrun
    arch, shape = cell.split()
    golden = json.loads(GOLDEN_MODELS.read_text())
    want = golden["cells"][cell]
    got = json.loads(json.dumps(model_dryrun.counts(
        dryrun.model_record(arch, shape, False))))
    same = torch.__version__.split("+")[0] == golden["torch"]
    assert model_dryrun.counts_differ(got, want, same) == {}
    if same:
        assert got == want


def test_meshes():
    m = launch_mesh.make_sql_mesh(device="cpu")
    assert m.axes == (("data", 256),) and launch_mesh.data_axes(m) == ("data",)
    m = launch_mesh.make_sql_mesh(multi_pod=True, device="cpu")
    assert m.shape == (2, 256) and launch_mesh.data_axes(m) == ("pod", "data")
    m = launch_mesh.make_production_mesh(multi_pod=True, device="cpu")
    assert m.axes == (("pod", 2), ("data", 16), ("model", 16))
    assert launch_mesh.data_axes(m) == ("pod", "data")
    assert launch_mesh.make_sql_mesh().device.type == "cuda"   # no card asked


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


def test_counting_mesh_bytes_by_kind():
    mesh = analysis.CountingMesh.like(
        ShardMesh((("pod", 2), ("data", 4)), torch.device("cpu")))
    x = torch.arange(8 * 4 * 3, dtype=torch.int64).reshape(8, 4, 3)
    assert torch.equal(mesh.all_to_all(x, "data"),
                       ShardMesh.all_to_all(mesh, x, "data"))
    mesh.all_gather(torch.zeros(8, 5, dtype=torch.int32), "pod")
    mesh.psum(torch.zeros(8, 2, dtype=torch.float32), "data")
    mesh.pmax(torch.zeros(8, 16, dtype=torch.uint8), "pod")
    assert mesh.collective_bytes() == {
        "all-to-all": 4 * 3 * 8.0,           # each shard's (4, 3) int64
        "all-gather": 2 * 5 * 4.0,           # (2 x 5,) int32 a shard
        "all-reduce": 2 * (2 * 4.0 + 16.0),  # counted double
        "total": 96.0 + 40.0 + 48.0}


def test_op_counter_traffic_and_peak():
    counter = analysis.OpCounter()
    with counter:
        a = torch.ones(1000, dtype=torch.float32)       # 4,000 B
        b = a + 1.0                                     # 8,000 live
        v = b[:10]                                      # a view: no bytes
        del a                                           # 4,000 live
        c = torch.cat([b, b])                           # 12,000 live
        del b                                           # v keeps b alive
        d = v * 2                                       # 12,040 live
    assert counter.peak == 12_040
    assert counter.live == 12_040                       # b (via v), c, d
    # ones: 4,000 out; add: 4,000 + 4,000; cat: 8,000 + 8,000; mul: 40 + 40
    assert counter.bytes_accessed == 4_000 + 8_000 + 16_000 + 80
    assert counter.element_ops == 1000 + 10              # add, mul
    del v, c, d
    assert counter.live == 0


def test_op_counter_on_fake_cuda_allocates_nothing():
    with analysis.fake_cuda() as dev:
        with analysis.OpCounter() as counter:
            x = torch.zeros((4, 1 << 30), dtype=torch.float64, device=dev)
            y = x[:, 1:] + x[:, :-1]
            y[:, 0] = 5.0
            z = torch.cumsum(y, -1).contiguous()
        assert z.is_cuda and z.shape == (4, (1 << 30) - 1)
        del x, y, z
    assert counter.peak == 3 * 4 * 8 * (1 << 30) - 2 * 32
    assert counter.live == 0


@pytest.mark.parametrize("index", [
    (slice(None), slice(1, None)), (Ellipsis, slice(None, -1)), 3,
    (Ellipsis, 0), "tensor", "two_tensors", (None, slice(2, 5)),
    (slice(None), "tensor")])
def test_fake_cuda_indexing_routes_equal_python_indexing(index):
    x = torch.arange(6 * 7, dtype=torch.int64).reshape(6, 7)
    rows = torch.tensor([[0], [5], [2]])
    cols = torch.tensor([[1, 6], [0, 0], [3, 2]])
    index = {"tensor": cols[:, 0], "two_tensors": (rows, cols)}.get(
        index if isinstance(index, str) else None, index)
    if isinstance(index, tuple) and index[-1] == "tensor":
        index = index[:-1] + (cols[:, 0],)
    assert torch.equal(analysis._getitem(x, index), x[index])
    want, got = x.clone(), x.clone()
    want[index] = -7
    analysis._setitem(got, index, -7)
    assert torch.equal(got, want)


def test_static_tier_on_sharded_frames_equals_one_shard_at_a_time():
    g = torch.Generator().manual_seed(3)
    shards, cap = 4, 64
    key = torch.randint(0, 20, (shards, cap), generator=g)
    valid = torch.rand((shards, cap), generator=g) < 0.7
    val = torch.rand((shards, cap), generator=g, dtype=torch.float64)
    date = torch.randint(0, 99, (shards, cap), generator=g, dtype=torch.int32)
    bkeys = torch.randint(0, 40, (shards, 30), generator=g)
    bvalid = torch.rand((shards, 30), generator=g) < 0.5
    build = Frame({"bk": torch.arange(30).repeat(shards, 1),
                   "x": torch.rand((shards, 30), generator=g)},
                  torch.ones(shards, 30, dtype=torch.bool))

    def run(k, v, x, d, bk, bv, b):
        fr = Frame({"v": x, "d": d, "k": k}, v)
        semi = static_ops.static_semi_join(fr, k, bk, bv)
        joined = static_ops.static_inner_join(semi, k, b, b.columns["bk"])
        agg, _ = static_ops.local_sort_agg(joined, k, {"s": x}, {"d": d})
        top = static_ops.static_topk(agg, agg.columns["s"], 5)
        return [joined.valid, joined.columns["x"], agg.valid,
                *agg.columns.values(), top.valid, *top.columns.values()]

    together = run(key, valid, val, date, bkeys, bvalid, build)
    for s in range(shards):
        one = run(key[s], valid[s], val[s], date[s], bkeys[s], bvalid[s],
                  Frame({c: t[s] for c, t in build.columns.items()},
                        build.valid[s]))
        for a, b in zip(one, together):
            assert torch.equal(a, b[s])


def test_fixed_point_sums_of_several_columns_equal_each_column_alone():
    """Q1's fragment sums a stacked (N, 6) float32 matrix: on the card that
    is ``fixed_point_segment_sum`` with trailing columns, each scaled by
    its own largest magnitude, bit for bit each column's own sum."""
    g = torch.Generator().manual_seed(5)
    x = (torch.rand((4000, 6), generator=g)
         * torch.tensor([50.0, 1e5, 9e4, 1e5, 0.1, 1.0]))
    ids = torch.randint(0, 10, (4000,), generator=g)
    got = fixed_point_segment_sum(x, ids, 12)
    assert got.shape == (12, 6) and got.dtype == torch.float32
    for j in range(6):
        assert torch.equal(got[:, j], fixed_point_segment_sum(x[:, j], ids, 12))
    want = torch.zeros(12, 6, dtype=torch.float64).index_add_(0, ids, x.double())
    torch.testing.assert_close(got.double(), want, rtol=2.0 ** -23, atol=0)
    assert fixed_point_segment_sum(x[:0], ids[:0], 3).shape == (3, 6)
