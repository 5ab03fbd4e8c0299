"""The port's model dry run (``launch/sharding.py``, ``launch/model_dryrun.py``,
the mesh-dependent model paths) against the JAX reference, on the CPU.

The reference runs once, in ``tests/_torch_launch_models_ref_worker.py``
(one subprocess, 512 forced host devices).

* **Exact.**  Every parameter's layout of all ten configurations (full
  size, shapes only), FSDP on and off, on the (16, 16) and (2, 16, 16)
  meshes, equals the reference's ``PartitionSpec`` of the same leaf
  (stacked leaves without their layer axis); so do the moments' and the
  step's, ``batch_shardings``', ``_batch_spec``'s (``long_500k``'s batch of
  1 included) and ``cache_shardings``' (by leaf), the cache's shapes and
  dtypes, ``input_specs``, every record's metadata and the cell list.
* **Argument bytes, exact**: each shard's argument bytes of reduced cells
  on (2, 4) and (2, 2, 2) meshes (and one device) equal the reference's
  ``memory_analysis().argument_size_in_bytes``: train, prefill and decode,
  the dense, MoE, MLA, Mamba, hybrid, whisper and llava families.
* **Matmul FLOPs**: the port's counter gives ``tests/test_hlo_analysis.py``'s
  four programs' ``dot_flops`` exactly; reduced cells' global matmul FLOPs
  on one device equal the reference's ``dot_flops`` within 2% (llama's
  train cell reads 0.9796, pinned: the reference's nested remat recomputes
  the score product once more, ROADMAP queue 3).
* **Per-shard figures beside the reference's** on the small meshes: the
  ratios of FLOPs, bytes accessed, collective bytes and temp bytes are
  pinned (``PINNED``); the departures and their causes are in ROADMAP
  queue 3.
* **Grouped MoE dispatch**: reduced phi3.5-moe's and jamba's ``MoE`` under
  a mesh of 2 and 4 data shards equal the reference's ``moe`` under the
  same mesh within 2e-5 in float32, at the default capacity and at one
  that drops tokens; with one group the layer is bit for bit the one
  without a mesh.
* A sampled run (one iteration of each long loop standing for all) counts
  what the whole run counts; the decode cells count ``decode_attention``
  by its formula.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_launch_models_ref_worker as ref_worker
from repro.launch.hlo_analysis import dot_flops
from repro_torch.configs.base import Shape, all_configs, get_config, reduced
from repro_torch.exchange.service import ShardMesh
from repro_torch.launch import analysis, dryrun, model_dryrun as md
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import convert, layers as L
from repro_torch.models.lm import CausalLM

torch.set_num_threads(1)

ARCHS = sorted(all_configs())
MESHES = (False, True)
SMALL_SHAPES = [("train_4k", 64, 8, "train"), ("prefill_32k", 128, 8, "prefill"),
                ("decode_32k", 128, 8, "decode"), ("long_500k", 256, 1, "decode")]
SMALL = {"1x1": (("data", 1), ("model", 1)),
         "2x4": (("data", 2), ("model", 4)),
         "2x2x2": (("pod", 2), ("data", 2), ("model", 2))}
COMPILED = [
    ("llama3.2-3b", "train_4k", "2x4"), ("llama3.2-3b", "prefill_32k", "2x4"),
    ("llama3.2-3b", "decode_32k", "2x2x2"), ("llama3.2-3b", "train_4k", "2x2x2"),
    ("phi3.5-moe-42b-a6.6b", "train_4k", "2x4"),
    ("deepseek-v2-lite-16b", "decode_32k", "2x4"),
    ("falcon-mamba-7b", "prefill_32k", "2x4"),
    ("falcon-mamba-7b", "long_500k", "2x2x2"),
    ("jamba-v0.1-52b", "decode_32k", "2x4"),
    ("whisper-medium", "train_4k", "2x4"),
    ("llava-next-mistral-7b", "prefill_32k", "2x2x2"),
    ("llama3.2-3b", "train_4k", "1x1"), ("llama3.2-3b", "prefill_32k", "1x1"),
    ("phi3.5-moe-42b-a6.6b", "train_4k", "1x1"),
    ("deepseek-v2-lite-16b", "decode_32k", "1x1"),
]
MOE_SEED = 20240611
MOE_CASES = [(arch, g, 8 // g, cf) for arch in ("phi3.5-moe-42b-a6.6b",
                                                  "jamba-v0.1-52b")
             for g in (2, 4) for cf in (1.25, 0.5)]


def _moe_cfg(arch, cf):
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _moe_case(arch):
    """Seeded numpy parameters of one reduced MoE layer and its input."""
    cfg = reduced(get_config(arch))
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(MOE_SEED)

    def draw(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"router": draw(d, m.n_experts, scale=d ** -0.5),
              "wg": draw(m.n_experts, d, m.expert_d_ff, scale=d ** -0.5),
              "wu": draw(m.n_experts, d, m.expert_d_ff, scale=d ** -0.5),
              "wd": draw(m.n_experts, m.expert_d_ff, d,
                         scale=m.expert_d_ff ** -0.5)}
    if m.n_shared:
        ff = m.n_shared * m.expert_d_ff
        params["shared"] = {"wg": draw(d, ff, scale=d ** -0.5),
                            "wu": draw(d, ff, scale=d ** -0.5),
                            "wd": draw(ff, d, scale=ff ** -0.5)}
    return {"params": params, "x": draw(8, 32, d, scale=1.0)}


@pytest.fixture(scope="module")
def ref():
    moe = {(arch, g, mm, cf): _moe_case(arch) for arch, g, mm, cf in MOE_CASES}
    return ref_worker.run({"shapes": SMALL_SHAPES, "compiled": COMPILED,
                           "moe": moe})


_MODELS = {}


def _meta_model(arch) -> CausalLM:
    if arch not in _MODELS:
        _MODELS[arch] = CausalLM(get_config(arch), device="meta")
    return _MODELS[arch]


def _mesh(multi_pod):
    return make_production_mesh(multi_pod=multi_pod, device="meta")


# ---------------------------------------------------------------------------
# layouts, specs and metadata, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("fsdp", (True, False))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_layouts_equal_the_reference(arch, fsdp, multi_pod, ref):
    model = _meta_model(arch)
    cfg = model.cfg
    want = ref["layouts"][(arch, fsdp, multi_pod, "params")]
    got = S.param_layouts(model, _mesh(multi_pod), fsdp=fsdp,
                          n_experts=cfg.moe.n_experts if cfg.moe else None)
    seen = set()
    for name, p in model.named_parameters():
        path, shape, stacked = S.reference_leaf(model, name, p.shape)
        assert path in want, (name, path)
        spec = want[path]
        assert got[name] == (spec[1:] if stacked else spec), (name, path)
        seen.add(path)
    assert seen == set(want)


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_layouts_equal_the_reference(arch, multi_pod, ref):
    model = _meta_model(arch)
    cfg = model.cfg
    params = S.param_layouts(model, _mesh(multi_pod), fsdp=True,
                             n_experts=cfg.moe.n_experts if cfg.moe else None)
    state = S.state_layouts(params)
    want = ref["layouts"][(arch, True, multi_pod, "opt")]
    assert state["opt"]["step"] == want["step"] == ()
    for name, p in model.named_parameters():
        path, _, stacked = S.reference_leaf(model, name, p.shape)
        for moment in ("mu", "nu"):
            spec = want[moment][path]
            assert state["opt"][moment][name] == (
                spec[1:] if stacked else spec)
    assert state["params"] is params


def _cells():
    return [(arch, s.name) for arch in ARCHS
            for s in get_config(arch).shapes()]


def _port_cache_path(model, i, leaf):
    """The reference's cache path of layer ``i``'s ``leaf`` and whether it
    is stacked."""
    if i < model.n_prefix:
        return f"/prefix/{i}/{leaf}", False
    j = (i - model.n_prefix) % model.period
    return f"/stack/sub{j}/{leaf}", True


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch,shape_name", _cells())
def test_batch_and_cache_layouts_equal_the_reference(arch, shape_name,
                                                     multi_pod, ref):
    cfg = get_config(arch)
    shape = next(s for s in cfg.shapes() if s.name == shape_name)
    mesh = _mesh(multi_pod)
    specs = md.input_specs(cfg, shape)
    assert {"/" + k: v for k, v in S.batch_layouts(specs, mesh).items()} \
        == ref["layouts"][(arch, shape_name, multi_pod, "batch")]
    bs = md.batch_spec(mesh, shape.global_batch)
    assert bs == ref["layouts"][(arch, shape_name, multi_pod, "batch_spec")]
    if shape.global_batch == 1:
        assert bs == (None,)
    if shape.kind != "decode":
        return
    model = _meta_model(arch)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    lays = md.cache_layouts(cache, mesh, shape.global_batch)
    want = ref["layouts"][(arch, shape_name, multi_pod, "cache")]
    shapes = ref["layouts"][(arch, shape_name, multi_pod, "cache_shapes")]
    seen = set()
    for i, layer in enumerate(cache["layers"]):
        for leaf, t in layer.items():
            path, stacked = _port_cache_path(model, i, leaf)
            spec, (shp, dtype) = want[path], shapes[path]
            assert lays["layers"][i][leaf] == (spec[1:] if stacked else spec)
            assert tuple(t.shape) == (shp[1:] if stacked else shp)
            assert str(t.dtype).replace("torch.", "") == dtype
            seen.add(path)
    for leaf in ("length", "enc_out"):
        if leaf in cache:
            assert lays[leaf] == want["/" + leaf]
            assert tuple(cache[leaf].shape) == shapes["/" + leaf][0]
            seen.add("/" + leaf)
    assert seen == set(want)


@pytest.mark.parametrize("arch,shape_name", _cells())
def test_input_specs_equal_the_reference(arch, shape_name, ref):
    cfg = get_config(arch)
    shape = next(s for s in cfg.shapes() if s.name == shape_name)
    got = {k: (s.shape, str(s.dtype).replace("torch.", ""))
           for k, s in md.input_specs(cfg, shape).items()}
    assert got == ref["input_specs"][(arch, shape_name)]


def test_record_metadata_and_cells_equal_the_reference(ref):
    models = [c for c in dryrun.all_cells() if c[0] != dryrun.SQL_ARCH]
    assert models == [c for c in ref["cells"] if c[0] != "sirius-tpch"]
    assert len(models) == 32
    for arch, shape_name in models:
        for mp in MESHES:
            got = dryrun.cell_metadata(arch, shape_name, mp)
            assert got == ref["meta"][(arch, shape_name, mp)], (arch, mp)


# ---------------------------------------------------------------------------
# the reduced cells against the reference's compiled ones
# ---------------------------------------------------------------------------


_RECORDS = {}


def _record(arch, shape_name, mesh_name, sample=True):
    key = (arch, shape_name, mesh_name, sample)
    if key not in _RECORDS:
        axes = SMALL[mesh_name]
        shape = next(Shape(*s) for s in SMALL_SHAPES if s[0] == shape_name)
        _RECORDS[key] = dryrun.model_record(
            arch, shape_name, len(axes) == 3, cfg=reduced(get_config(arch)),
            shape=shape, mesh=ShardMesh(axes, torch.device("meta")),
            sample=sample)
    return _RECORDS[key]


@pytest.mark.parametrize("arch,shape_name,mesh_name", COMPILED)
def test_argument_bytes_equal_the_reference(arch, shape_name, mesh_name, ref):
    got = _record(arch, shape_name, mesh_name)
    want = ref["compiled"][(arch, shape_name, mesh_name)]
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    assert got["n_chips"] == math.prod(n for _, n in SMALL[mesh_name])


# within 2% on one device; llama3.2-3b's train cell reads 0.9796 (the
# reference's nested remat recomputes the score product of a dense stack
# once more: ROADMAP queue 3), pinned in PINNED with the other ratios
ONE_DEVICE = [c for c in COMPILED if c[2] == "1x1"
              and c[:2] != ("llama3.2-3b", "train_4k")]
FLOPS_RTOL = 0.02


@pytest.mark.parametrize("arch,shape_name,mesh_name", ONE_DEVICE)
def test_global_matmul_flops_on_one_device(arch, shape_name, mesh_name, ref):
    got = _record(arch, shape_name, mesh_name)["flops_detail"]
    want = ref["compiled"][(arch, shape_name, mesh_name)]["dot_flops"]
    assert got["dot_flops_loop_corrected"] == pytest.approx(want,
                                                           rel=FLOPS_RTOL)


# port / reference per shard: matmul FLOPs, bytes accessed, collective
# bytes (totals) and temp bytes.  FLOPs within 7% everywhere; bytes accessed
# 1.1-7.5x (an eager program reads and writes every op's operands, where
# XLA fuses); collectives and temp bytes follow each side's schedule (the
# departures past 2x and their causes: ROADMAP queue 3)
PINNED = {
    ('llama3.2-3b', 'train_4k', '2x4'):
        {"dot_flops": 0.9796, "bytes_accessed": 3.8426, "collective_total": 0.3974, "temp": 1.0475},
    ('llama3.2-3b', 'prefill_32k', '2x4'):
        {"dot_flops": 1.0000, "bytes_accessed": 6.5883, "collective_total": 0.8886, "temp": 1.5221},
    ('llama3.2-3b', 'decode_32k', '2x2x2'):
        {"dot_flops": 1.0000, "bytes_accessed": 1.1188, "collective_total": 0.9857, "temp": 0.0198},
    ('llama3.2-3b', 'train_4k', '2x2x2'):
        {"dot_flops": 0.9796, "bytes_accessed": 3.4638, "collective_total": 0.3295, "temp": 1.1000},
    ('phi3.5-moe-42b-a6.6b', 'train_4k', '2x4'):
        {"dot_flops": 1.0087, "bytes_accessed": 3.5994, "collective_total": 0.3122, "temp": 1.4356},
    ('deepseek-v2-lite-16b', 'decode_32k', '2x4'):
        {"dot_flops": 1.0016, "bytes_accessed": 2.3043, "collective_total": 0.9013, "temp": 0.5657},
    ('falcon-mamba-7b', 'prefill_32k', '2x4'):
        {"dot_flops": 1.0181, "bytes_accessed": 3.8443, "collective_total": 0.2426, "temp": 0.6848},
    ('falcon-mamba-7b', 'long_500k', '2x2x2'):
        {"dot_flops": 1.0618, "bytes_accessed": 3.6631, "collective_total": 5.8429, "temp": 4.3512},
    ('jamba-v0.1-52b', 'decode_32k', '2x4'):
        {"dot_flops": 1.0086, "bytes_accessed": 1.2263, "collective_total": 1.1515, "temp": 0.1406},
    ('whisper-medium', 'train_4k', '2x4'):
        {"dot_flops": 0.9721, "bytes_accessed": 5.3544, "collective_total": 0.5944, "temp": 10.0395},
    ('llava-next-mistral-7b', 'prefill_32k', '2x2x2'):
        {"dot_flops": 1.0000, "bytes_accessed": 5.6412, "collective_total": 0.5663, "temp": 1.4314},
    ('llama3.2-3b', 'train_4k', '1x1'):
        {"dot_flops": 0.9796, "bytes_accessed": 4.4720, "collective_total": 0.0000, "temp": 0.9639},
    ('llama3.2-3b', 'prefill_32k', '1x1'):
        {"dot_flops": 1.0000, "bytes_accessed": 7.4669, "collective_total": 0.0000, "temp": 1.5781},
    ('phi3.5-moe-42b-a6.6b', 'train_4k', '1x1'):
        {"dot_flops": 0.9826, "bytes_accessed": 4.1653, "collective_total": 0.0000, "temp": 1.5162},
    ('deepseek-v2-lite-16b', 'decode_32k', '1x1'):
        {"dot_flops": 1.0000, "bytes_accessed": 2.5824, "collective_total": 0.0000, "temp": 0.6579},
}



def _ratios(got, want):
    coll, wcoll = (got["collective_bytes_per_device"],
                   want["collective_bytes_per_device"])
    return {
        "dot_flops": got["flops_detail"]["dot_flops_loop_corrected"]
        / want["dot_flops"],
        "bytes_accessed": got["bytes_accessed_per_device"]
        / want["bytes_accessed_per_device"],
        "collective_total": (coll["total"] / wcoll["total"]
                             if wcoll["total"] else float(coll["total"])),
        "temp": got["memory"]["temp_bytes"]
        / max(want["memory"]["temp_bytes"], 1)}


@pytest.mark.parametrize("arch,shape_name,mesh_name", COMPILED)
def test_per_shard_figures_beside_the_reference(arch, shape_name, mesh_name,
                                                ref):
    got = _record(arch, shape_name, mesh_name)
    want = ref["compiled"][(arch, shape_name, mesh_name)]
    ratios = _ratios(got, want)
    pinned = PINNED[(arch, shape_name, mesh_name)]
    for key, value in pinned.items():
        assert ratios[key] == pytest.approx(value, rel=1e-3), (key, ratios)


# ---------------------------------------------------------------------------
# the counter against hlo_analysis's known programs
# ---------------------------------------------------------------------------


def _jax_dot_flops(f, *shapes):
    c = jax.jit(f).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                           for s in shapes]).compile()
    return dot_flops(c.as_text())


def _scan(c, w, n):
    for _ in range(n):
        c = c @ w
    return c


HLO_CASES = {
    "single_matmul": (lambda a, b: a @ b, lambda a, b: a @ b,
                      ((64, 128), (128, 32))),
    "scan_7": (lambda x, w: jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                                         length=7)[0],
               lambda x, w: _scan(x, w, 7), ((128, 128), (128, 128))),
    "nested_3x5": (lambda x, w: jax.lax.scan(
        lambda c, _: (jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None,
                                   length=3)[0], None), x, None, length=5)[0],
        lambda x, w: _scan(x, w, 15), ((128, 128), (128, 128))),
    "batched_einsum": (lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                       lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                       ((4, 32, 64), (4, 64, 16))),
}


@pytest.mark.parametrize("case", sorted(HLO_CASES))
def test_counter_reproduces_the_hlo_analysis_cases(case):
    jf, tf, shapes = HLO_CASES[case]
    args = [torch.empty(s, device="meta") for s in shapes]
    with analysis.OpCounter() as counter:
        tf(*args)
    assert counter.flops == _jax_dot_flops(jf, *shapes)
    detail = analysis.loop_corrected_flops(counter)
    assert detail["dot_flops_loop_corrected"] == counter.flops
    assert detail["flops"] == max(detail["cost_analysis_flops"],
                                  counter.flops)


# ---------------------------------------------------------------------------
# grouped MoE dispatch
# ---------------------------------------------------------------------------


def _port_moe(arch, cf, params):
    cfg = _moe_cfg(arch, cf)
    moe = L.MoE(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    with torch.no_grad():
        convert._load_module(moe, params, "moe")
    return moe


@pytest.mark.parametrize("arch,groups,model_axis,cf", MOE_CASES)
def test_grouped_moe_equals_the_reference(arch, groups, model_axis, cf, ref):
    case = _moe_case(arch)
    moe = _port_moe(arch, cf, case["params"])
    x = torch.tensor(case["x"])
    mesh = L.MeshContext((("data", groups), ("model", model_axis)))
    with L.mesh_context(mesh), torch.no_grad():
        got = moe(x).numpy()
    want = ref["moe"][(arch, groups, model_axis, cf)]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    t = x.shape[0] * x.shape[1]
    assert L._moe_groups(t) == 1           # the mesh is gone again
    # each group's (x.reshape(G, t/G, d)) pin was recorded
    assert (groups, t // groups, x.shape[-1]) in [s for s, _ in mesh.pins]
    if cf < 1.0:    # the low capacity drops (token, expert) pairs
        with torch.no_grad():
            slot, _, _, cap = moe.route(x.reshape(t, -1)[:t // groups],
                                        moe.router)
        assert int((slot == moe.cfg.moe.n_experts * cap).sum()) > 0


@pytest.mark.parametrize("arch", ("phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"))
def test_one_group_moe_is_bit_for_bit_unchanged(arch):
    case = _moe_case(arch)
    moe = _port_moe(arch, 1.25, case["params"])
    x = torch.tensor(case["x"])
    with torch.no_grad():
        plain = moe(x)
        for axes in ((("data", 1), ("model", 4)), (("data", 4),),
                     (("data", 3), ("model", 2))):      # 256 % 3: one group
            with L.mesh_context(L.MeshContext(axes)):
                assert torch.equal(moe(x), plain), axes


# ---------------------------------------------------------------------------
# the shard program's mechanics
# ---------------------------------------------------------------------------


# long enough that the q and kv blocks of the attention and Mamba's steps
# are sampled
SAMPLED = [("llama3.2-3b", Shape("train_4k", 1536, 2, "train"), "2x4"),
           ("llama3.2-3b", Shape("prefill_32k", 2560, 2, "prefill"), "2x4"),
           ("falcon-mamba-7b", Shape("train_4k", 256, 2, "train"), "2x4"),
           ("whisper-medium", Shape("train_4k", 1536, 2, "train"), "2x2x2"),
           ("deepseek-v2-lite-16b", Shape("train_4k", 2048, 2, "train"),
            "2x4")]


@pytest.mark.parametrize("arch,shape,mesh_name", SAMPLED,
                         ids=[f"{a}-{s.kind}-{m}" for a, s, m in SAMPLED])
def test_sampled_loops_count_what_the_whole_run_counts(arch, shape,
                                                       mesh_name):
    """Matmul FLOPs and collectives exactly; bytes and element operations
    within 1% (the gradients the skipped iterations' backward would add up
    are counted from the sampled one's uses, and the adding up inside the
    iterations run stands for all); the peak within 15% (the skipped
    iterations' transient gradients are not held: falcon-mamba's reads
    0.887 of the whole run's, the others 0.98-1.0)."""
    axes = SMALL[mesh_name]
    sampled, whole = (dryrun.model_record(
        arch, shape.name, len(axes) == 3, cfg=reduced(get_config(arch)),
        shape=shape, mesh=ShardMesh(axes, torch.device("meta")), sample=s)
        for s in (True, False))
    assert sampled["flops_detail"]["dot_flops_loop_corrected"] == \
        whole["flops_detail"]["dot_flops_loop_corrected"]
    assert sampled["collective_bytes_per_device"] == \
        whole["collective_bytes_per_device"]
    for key in ("bytes_accessed_per_device", "element_ops_per_device"):
        assert sampled[key] == pytest.approx(whole[key], rel=0.01), key
    assert sampled["memory"]["argument_bytes"] == \
        whole["memory"]["argument_bytes"]
    assert sampled["memory"]["resident_bytes_per_chip"] == pytest.approx(
        whole["memory"]["resident_bytes_per_chip"], rel=0.15)


@pytest.mark.parametrize("arch,mesh_name", [("llama3.2-3b", "2x4"),
                                            ("whisper-medium", "2x2x2")])
def test_decode_cells_count_decode_attention_by_its_formula(arch, mesh_name):
    from repro_torch.kernels.decode_attention import decode_attention_flops
    rec = _record(arch, "decode_32k", mesh_name)
    cfg = reduced(get_config(arch))
    sizes = dict(SMALL[mesh_name])
    b = 8 // math.prod(n for a, n in sizes.items() if a != "model")
    s_local = 128 // sizes["model"]
    want = cfg.n_layers * decode_attention_flops(
        (b, cfg.n_heads, cfg.resolved_head_dim),
        (b, s_local, cfg.n_kv_heads, cfg.resolved_head_dim))
    got = rec["flops_detail"]["dot_flops_by_op"]
    assert got["repro_torch.decode_attention.default"] == want


def test_decode_attention_on_meta_is_one_shape_only_op():
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_flops,
    )
    q = torch.empty(2, 8, 64, device="meta")
    k = torch.empty(2, 300, 4, 64, device="meta")
    lengths = torch.empty(2, dtype=torch.int32, device="meta")
    before = build.launch_counts().get("decode_attention", 0)
    with analysis.OpCounter() as counter:
        out = decode_attention(q, k, k, lengths)
    assert out.shape == q.shape and out.is_meta
    assert counter.flops == decode_attention_flops(q.shape, k.shape) \
        == 4 * 2 * 8 * 300 * 64
    assert build.launch_counts().get("decode_attention", 0) == before


def test_local_shapes_pad_uneven_splits_and_count_bytes():
    mesh = ShardMesh((("pod", 2), ("data", 16), ("model", 16)),
                     torch.device("meta"))
    lay = S.layout([("pod", "data"), "model"], 2)
    assert lay == (("pod", "data"), ("model",))
    assert S.local_shape((3072, 3000), lay, mesh) == (
        (96, 188), [(1, 3000, 16)])
    assert S.shard_bytes((3072, 3000), torch.bfloat16, lay, mesh) == \
        96 * 188 * 2
    assert S.local_shape((7,), (None,), mesh) == ((7,), [])


def test_constrain_follows_the_reference_rule():
    sizes = {"pod": 2, "data": 4, "model": 8}
    assert L.constrain_spec((16, 24, 3), ("batch", "model", None), sizes) \
        == (("pod", "data"), "model", None)
    assert L.constrain_spec((12, 12, 3), ("batch", "model", None), sizes) \
        == (None, None, None)
    assert L.constrain_spec((4, 8), ("batch", "model"), {"data": 4}) is None
    mesh = L.MeshContext((("data", 4), ("model", 8)))
    x = torch.zeros(8, 16, 2)
    with L.mesh_context(mesh):
        assert L.constrain(x, "batch", "model", None) is x
    assert mesh.pins == [((8, 16, 2), ("data", "model", None))]
    assert L.constrain(x, "batch") is x and L.get_mesh() is None


def test_model_cell_record_has_the_reference_keys():
    rec = _record("jamba-v0.1-52b", "decode_32k", "2x4")
    assert {"flops_per_device", "flops_detail", "bytes_accessed_per_device",
            "collective_bytes_per_device", "memory", "n_chips"} <= set(rec)
    assert {"cost_analysis_flops", "dot_flops_loop_corrected",
            "flops"} <= set(rec["flops_detail"])
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "resident_bytes_per_chip", "fits_card"} <= set(rec["memory"])
    assert rec["memory"]["resident_bytes_per_chip"] == (
        rec["memory"]["argument_bytes"] + rec["memory"]["output_bytes"]
        + rec["memory"]["temp_bytes"])

