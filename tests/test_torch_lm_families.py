"""The port's MoE, MLA, Mamba and hybrid families against the JAX package,
on the CPU: phi3.5-moe, deepseek-v2-lite (MLA + MoE, a dense prefix
layer), falcon-mamba and jamba (periods of Mamba and attention layers, MoE
every second layer).

The same parameters (the reference's ``init_params`` tree, its norm-like
leaves perturbed so that they matter, carried across with
``params_from_numpy``) and the same tokens go through both packages.  The
reference runs jitted, as its forward and decode steps always do.
Tolerances: float32 within 2e-4, bfloat16 within 3e-2 (those of
``test_torch_models.py``), greedy tokens exactly.
"""
import dataclasses

import repro.relational.table  # noqa: F401 — turns x64 on, as other files do
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import layers as RL
from repro.models import lm as rlm
from repro_torch import configs
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve_lm import serve

torch.set_num_threads(1)

FAMILIES = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
            "jamba-v0.1-52b")
F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# leaves that init_params sets to ones, zeros or a fixed pattern
PERTURBED = {"ln1", "ln2", "final_norm", "q_norm", "k_norm", "bq", "bk", "bv",
             "kv_norm", "d_skip", "dt_bias"}


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    x = np.asarray(tree)
    if name in PERTURBED:
        x = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    return x


def _cfgs(arch, dtype="float32", **changes):
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype,
                               **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype, **changes)
    return rcfg, cfg


def _models(arch, dtype="float32", seed=0):
    """(reference cfg, reference params, port cfg, port model) with one
    perturbed parameter tree."""
    rcfg, cfg = _cfgs(arch, dtype)
    tree = _perturb(rlm.init_params(jax.random.PRNGKey(seed), rcfg),
                    np.random.default_rng(seed))
    params = jax.tree.map(jnp.asarray, tree)
    return rcfg, params, cfg, params_from_numpy(cfg, tree, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _load(module, tree):
    """Copy a reference layer's params (f32 numpy) into a port module."""
    for key, param in module.named_parameters():
        sub = tree
        for part in key.split("."):
            sub = sub[part]
        param.data.copy_(torch.tensor(np.asarray(sub)))


def _close(got, want, vocab, tol):
    np.testing.assert_allclose(_np(got)[..., :vocab], _np(want)[..., :vocab],
                               **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_configs_equal_the_reference(arch):
    ref, mine = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced(mine)) == \
        dataclasses.asdict(ref_reduced(ref))
    for sub in ("moe", "mamba", "mla"):
        assert (getattr(mine, sub) is None) == (getattr(ref, sub) is None)
        if getattr(mine, sub) is not None:
            assert type(getattr(mine, sub)).__module__ == \
                "repro_torch.configs.base"


def _port_cfg(ref_cfg):
    """The port's ArchConfig with the reference config's fields, its
    sub-configs rebuilt as the port's dataclasses."""
    sub = {"moe": configs.MoECfg, "mamba": configs.MambaCfg,
           "mla": configs.MLACfg}
    fields = {}
    for f in dataclasses.fields(ref_cfg):
        v = getattr(ref_cfg, f.name)
        if f.name in sub and v is not None:
            v = sub[f.name](**dataclasses.asdict(v))
        fields[f.name] = v
    return configs.ArchConfig(**fields)


@pytest.mark.parametrize("arch", sorted(ref_base.all_configs()))
def test_param_counts_equal_the_reference(arch):
    ref = ref_get_config(arch)
    mine = _port_cfg(ref)
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    small = ref_reduced(ref)
    assert _port_cfg(small).param_count() == small.param_count()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe(arch, dtype="float32", seed=3, router_scale=1.0, **changes):
    rcfg, cfg = _cfgs(arch, dtype, **changes)
    p = jax.tree.map(np.asarray, RL.init_moe(jax.random.PRNGKey(seed), rcfg))
    p["router"] = p["router"] * router_scale
    mod = L.MoE(cfg, torch.Generator(), "cpu", getattr(torch, dtype))
    _load(mod, p)
    return rcfg, jax.tree.map(jnp.asarray, p), mod


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"])
def test_moe_matches(arch):
    """phi (no shared expert) and deepseek (one shared expert after
    reduced()), float32."""
    rcfg, p, mod = _moe(arch)
    assert (mod.shared is not None) == bool(rcfg.moe.n_shared)
    x = np.random.default_rng(3).normal(size=(2, 16, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: RL.moe(p, rcfg, x))(p, jnp.asarray(x))
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), _np(want),
                               **F32_TOL)


def test_moe_drops_the_overflow_as_the_reference_does():
    """A router skewed towards one expert: every token picks it, its
    capacity (16 rows for 32 tokens) overflows and the overflow is dropped,
    in both packages; with a capacity factor of E / k nothing drops."""
    arch = "phi3.5-moe-42b-a6.6b"
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 16, 64)) + 1.0).astype(np.float32)
    outs = {}
    for cf in (1.25, 4.0):
        rcfg, p, mod = _moe(arch, seed=4)
        rcfg.moe.capacity_factor = mod.cfg.moe.capacity_factor = cf
        skew = np.zeros((64, rcfg.moe.n_experts), np.float32)
        skew[:, 0] = 5.0
        p["router"] = p["router"] + jnp.asarray(skew)
        mod.router.data += torch.from_numpy(skew)
        xt = torch.from_numpy(x)
        slot, tok, w, cap = mod.route(xt.reshape(-1, 64), mod.router)
        dropped = int((slot == rcfg.moe.n_experts * cap).sum())
        want = jax.jit(lambda p, x: RL.moe(p, rcfg, x))(p, jnp.asarray(x))
        got = mod(xt)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
        outs[cf] = (dropped, cap, _np(got))
    dropped, cap, y_drop = outs[1.25]
    assert cap == 16 and dropped >= 32 - 16
    assert outs[4.0][0] == 0
    assert np.abs(y_drop - outs[4.0][2]).max() > 1e-3


@pytest.mark.parametrize("stacked", [False, True])
def test_moe_bf16_routes_in_float32(stacked):
    """bf16 input and experts, the router math float32: as the reference's
    decode step (float32 router) and, ``stacked``, as its forward (router
    rounded to bf16 first)."""
    rcfg, p, mod = _moe("jamba-v0.1-52b", "bfloat16", seed=5)
    assert mod.router.dtype == torch.float32 and mod.wg.dtype == torch.bfloat16
    if stacked:
        p = jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)
    x = np.random.default_rng(5).normal(size=(2, 16, 64)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax.jit(lambda p, x: RL.moe(p, rcfg, x))(p, xb)
    got = mod(torch.tensor(_np(xb)).bfloat16(), stacked)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_moe_combine_adds_in_the_reference_order():
    """k = 6 bf16 contributions of 64 tokens, sorted by expert as the
    dispatch leaves them: the combine equals the reference's
    ``zeros(...).at[tok].add(contrib)`` bit for bit.  Summing each token's
    rows in float32 and rounding once, or in another order, does not."""
    rng = np.random.default_rng(6)
    t, k, d, e = 64, 6, 32, 16
    flat_e = np.concatenate([rng.choice(e, k, replace=False) for _ in range(t)])
    tok = np.argsort(flat_e, kind="stable") // k
    contrib = (rng.normal(size=(t * k, d))
               * np.exp(3 * rng.normal(size=(t * k, 1)))).astype(np.float32)
    cb = jnp.asarray(contrib).astype(jnp.bfloat16)
    want = _np(jax.jit(lambda c, i: jnp.zeros((t, d), jnp.bfloat16)
                       .at[i].add(c))(cb, jnp.asarray(tok)))
    ct, tt = torch.tensor(_np(cb)).bfloat16(), torch.from_numpy(tok)
    got = L.moe_combine(ct, tt, t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)
    once = torch.zeros(t, d).index_add_(0, tt, ct.float()).bfloat16()
    backwards = L.moe_combine(ct.flip(0), tt.flip(0), t)
    assert (_np(once) != want).any() and (_np(backwards) != want).any()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla(seed):
    rcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    p = _perturb(RL.init_mla(jax.random.PRNGKey(seed), rcfg),
                 np.random.default_rng(seed))
    mod = L.MLA(cfg, torch.Generator(), "cpu", torch.float32)
    _load(mod, p)
    return rcfg, jax.tree.map(jnp.asarray, p), mod


def test_mla_train_matches():
    rcfg, p, mod = _mla(7)
    x = np.random.default_rng(7).normal(size=(2, 12, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: RL.mla_train(p, rcfg, x))(p, jnp.asarray(x))
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), _np(want),
                               **F32_TOL)


def test_mla_decode_matches_including_a_full_cache():
    """Lengths S-1, S and S+3 hit dynamic_update_slice's clamp: the latent
    row lands on row S-1 and the mask admits every row."""
    rcfg, p, mod = _mla(8)
    m = rcfg.mla
    rng = np.random.default_rng(8)
    b, s = 4, 8
    x = rng.normal(size=(b, 1, 64)).astype(np.float32)
    ckv = rng.normal(size=(b, s, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(b, s, m.qk_rope_head_dim)).astype(np.float32)
    length = np.array([2, s - 1, s, s + 3], np.int32)
    o_ref, ckv_ref, kr_ref = jax.jit(
        lambda p, *a: RL.mla_decode(p, rcfg, *a))(
            p, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
            jnp.asarray(length))
    ckv_t, kr_t = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    o = mod.decode(torch.from_numpy(x), ckv_t, kr_t, torch.from_numpy(length))
    np.testing.assert_allclose(_np(o), _np(o_ref), **F32_TOL)
    np.testing.assert_allclose(ckv_t.numpy(), _np(ckv_ref), **F32_TOL)
    np.testing.assert_allclose(kr_t.numpy(), _np(kr_ref), **F32_TOL)
    written = np.minimum(length, s - 1)
    for i in range(b):
        keep = np.arange(s) != written[i]
        np.testing.assert_array_equal(ckv_t.numpy()[i, keep], ckv[i, keep])


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def _mamba(seed, dtype="float32"):
    rcfg, cfg = _cfgs("falcon-mamba-7b", dtype)
    p = _perturb(RL.init_mamba(jax.random.PRNGKey(seed), rcfg),
                 np.random.default_rng(seed))
    mod = L.Mamba(cfg, torch.Generator(), "cpu", getattr(torch, dtype))
    _load(mod, p)
    return rcfg, jax.tree.map(jnp.asarray, p), mod


def test_causal_conv_matches():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        xj, wj = jnp.asarray(x).astype(dt), jnp.asarray(w)
        want = RL._causal_conv(xj, wj)
        got = L._causal_conv(torch.tensor(_np(xj)).to(getattr(torch, dt)),
                             torch.from_numpy(w))
        np.testing.assert_array_equal(_np(got), _np(want))


def test_mamba_train_matches():
    rcfg, p, mod = _mamba(10)
    x = np.random.default_rng(10).normal(size=(2, 12, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: RL.mamba_train(p, rcfg, x))(p, jnp.asarray(x))
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), _np(want),
                               **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_and_keeps_a_log_float32(dtype):
    """One step from a random state: the output and the new conv and ssm
    states.  The ssm state is float32 in both dtypes, held at the float32
    tolerance: the reference's decode uses ``a_log`` as stored (float32),
    and a bf16-rounded ``a_log`` moves the state past that tolerance."""
    rcfg, p, mod = _mamba(11, dtype)
    mm = rcfg.mamba
    din = mm.expand * 64
    rng = np.random.default_rng(11)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.normal(size=(3, 1, 64)).astype(np.float32)).astype(jdt)
    conv = jnp.asarray(rng.normal(size=(3, mm.d_conv - 1, din))
                       .astype(np.float32)).astype(jdt)
    ssm = jnp.asarray(rng.normal(size=(3, din, mm.d_state)).astype(np.float32))
    step = jax.jit(lambda p, *a: RL.mamba_decode(p, rcfg, *a))
    y_ref, conv_ref, ssm_ref = step(p, x, conv, ssm)
    tdt = getattr(torch, dtype)
    y, conv_t, ssm_t = mod.decode(torch.tensor(_np(x)).to(tdt),
                                  torch.tensor(_np(conv)).to(tdt),
                                  torch.tensor(np.asarray(ssm)))
    assert mod.a_log.dtype == ssm_t.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(y), _np(y_ref), **tol)
    np.testing.assert_array_equal(_np(conv_t), _np(conv_ref))
    np.testing.assert_allclose(ssm_t.numpy(), _np(ssm_ref), **F32_TOL)
    rounded = dict(p, a_log=p["a_log"].astype(jnp.bfloat16).astype(jnp.float32))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(step(rounded, x, conv, ssm)[2]),
                                   _np(ssm_ref), **F32_TOL)


def test_mamba_decode_matches_train_scan():
    """The reference's own check, on the port: stepping decode over a
    sequence gives the full scan's output."""
    _, _, mod = _mamba(12)
    mm = mod.cfg.mamba
    b, s, din = 1, 12, mm.expand * 64
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(b, s, 64)).astype(np.float32))
    full = mod(x)
    conv = torch.zeros(b, mm.d_conv - 1, din)
    ssm = torch.zeros(b, din, mm.d_state)
    outs = []
    for i in range(s):
        y, conv, ssm = mod.decode(x[:, i:i + 1], conv, ssm)
        outs.append(y[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode_step
# ---------------------------------------------------------------------------


def _ref_cache_layer(cache_ref, cfg, li):
    """Layer ``li``'s cache dict in the reference's prefix / stack tree."""
    n_prefix = cfg.first_dense_layers
    if li < n_prefix:
        return cache_ref["prefix"][li]
    i, j = divmod(li - n_prefix, rlm._period_len(cfg))
    return {k: v[i] for k, v in cache_ref["stack"][f"sub{j}"].items()}


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in FAMILIES]
                         + [("falcon-mamba-7b", "bfloat16")])
def test_forward_prefill_and_decode_match(arch, dtype):
    rcfg, params, cfg, model = _models(arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    b, s, steps, cache_len = 2, 10, 6, 16
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (b, s))
    fwd = jax.jit(lambda p, t: rlm.logits_fn(p, rcfg, rlm.forward(p, rcfg, t)))
    got = model.logits_fn(model.forward(torch.from_numpy(toks)))
    assert got.shape == (b, s, cfg.padded_vocab)
    want = fwd(params, jnp.asarray(toks))
    _close(got, want, cfg.vocab, tol)
    # the reference's prefill is logits_fn of the forward's last position
    _close(model.prefill(torch.from_numpy(toks)), want[:, -1:], cfg.vocab, tol)

    step = jax.jit(lambda p, c, t: rlm.decode_step(p, rcfg, c, t))
    cache_ref = rlm.init_cache(rcfg, b, cache_len)
    cache = model.init_cache(b, cache_len)
    for i in range(steps):
        t = toks[:, i:i + 1]
        lg_ref, cache_ref = step(params, cache_ref, jnp.asarray(t))
        lg, cache = model.decode_step(cache, torch.from_numpy(t))
        _close(lg, lg_ref, cfg.vocab, tol)
    np.testing.assert_array_equal(cache["length"].numpy(),
                                  np.asarray(cache_ref["length"]))
    for li, c in enumerate(cache["layers"]):
        want = _ref_cache_layer(cache_ref, rcfg, li)
        assert set(c) == set(want)
        for key in c:
            assert c[key].dtype == (torch.float32 if key == "ssm"
                                    else model.dtype)
            np.testing.assert_allclose(_np(c[key]), _np(want[key]), **tol)


@pytest.fixture(scope="module")
def jamba_bf16():
    """Reduced jamba in bf16 with the reference's ``init_params`` tree as it
    is (norms, ``d_skip`` at one).  Then the two packages' bf16 forward and
    decode agree bit for bit, and the rounding of the router and ``a_log``
    is what the tests below can see.  With those leaves perturbed, XLA's
    float32 shortcuts that the port does not follow (ROADMAP.md, queue 3)
    move a few of the 16-layer model's logits past the bf16 tolerance."""
    rcfg, cfg = _cfgs("jamba-v0.1-52b", "bfloat16")
    tree = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(1), rcfg))
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(cfg, tree, device="cpu"))


def test_bf16_forward_rounds_router_and_a_log_in_the_stack(jamba_bf16):
    """The reference's forward casts every stacked float32 leaf of three or
    more dimensions (with the period axis) to bf16 before its scan: the MoE
    router and Mamba's ``a_log`` are rounded there.  The port's forward
    matches; the same blocks with both kept float32 do not."""
    rcfg, params, cfg, model = jamba_bf16
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 10))
    want = jax.jit(lambda p, t: rlm.logits_fn(p, rcfg, rlm.forward(p, rcfg, t)))(
        params, jnp.asarray(toks))
    _close(model.logits_fn(model.forward(torch.from_numpy(toks))), want,
           cfg.vocab, BF16_TOL)
    x, x32 = model.embed[torch.from_numpy(toks)].to(model.dtype), None
    for i, block in enumerate(model.blocks):
        x, x32 = block(x, model._x32(i, x32), stacked=False)
    unrounded = model.logits_fn(L.rmsnorm(x, model.final_norm, cfg.norm_eps))
    with pytest.raises(AssertionError):
        _close(unrounded, want, cfg.vocab, BF16_TOL)


def test_bf16_decode_keeps_router_and_a_log_float32(jamba_bf16):
    """The reference's decode step uses the stored float32 router and
    ``a_log``: teacher-forced bf16 decode logits match it, and a model whose
    routers hold bf16-rounded values does not."""
    rcfg, params, cfg, model = jamba_bf16
    b, steps = 2, 6
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (b, steps))
    step = jax.jit(lambda p, c, t: rlm.decode_step(p, rcfg, c, t))
    cache_ref = rlm.init_cache(rcfg, b, 16)
    want = []
    for i in range(steps):
        lg, cache_ref = step(params, cache_ref, jnp.asarray(toks[:, i:i + 1]))
        want.append(lg)

    def decoded():
        cache = model.init_cache(b, 16)
        return [model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]))[0]
                for i in range(steps)]

    for got, w in zip(decoded(), want):
        _close(got, w, cfg.vocab, BF16_TOL)
    routers = [blk.ffn.router for blk in model.blocks if blk.kind.ffn == "moe"]
    kept = [r.data.clone() for r in routers]
    try:
        for r in routers:
            r.data = r.data.to(torch.bfloat16).to(torch.float32)
        with pytest.raises(AssertionError):
            for got, w in zip(decoded(), want):
                _close(got, w, cfg.vocab, BF16_TOL)
    finally:
        for r, k in zip(routers, kept):
            r.data = k


def test_decode_matches_forward_incrementally():
    """Teacher-forced decode logits of reduced jamba (all three cache kinds)
    equal the parallel forward's, float32, within the reference's own 2e-3;
    the capacity factor is E / k so that the forward drops nothing."""
    rcfg, cfg = _cfgs("jamba-v0.1-52b")
    cfg.moe.capacity_factor = cfg.moe.n_experts / cfg.moe.top_k
    tree = _perturb(rlm.init_params(jax.random.PRNGKey(2), rcfg),
                    np.random.default_rng(2))
    model = params_from_numpy(cfg, tree, device="cpu")
    b, s = 2, 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (b, s)))
    full = model.logits_fn(model.forward(toks))
    cache = model.init_cache(b, s + 1)
    outs = [model.decode_step(cache, toks[:, i:i + 1])[0][:, 0] for i in range(s)]
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the reference's serving example, and carrying weights across
# ---------------------------------------------------------------------------


def test_serve_gives_the_tokens_of_the_reference_serving_example():
    """examples/serve_lm.py: reduced jamba from PRNGKey(0), batch 4, prompts
    of 5, 9, 3 and 7 tokens from default_rng(0), 16 new tokens, a 96-row
    cache; its loop runs here on the same weights."""
    cfg_ref = ref_reduced(ref_get_config("jamba-v0.1-52b"))
    params = rlm.init_params(jax.random.PRNGKey(0), cfg_ref)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_ref.vocab, n) for n in (5, 9, 3, 7)]
    batch, max_cache, n_new = 4, 96, 16
    cache = rlm.init_cache(cfg_ref, batch, max_cache)
    decode = jax.jit(lambda p, c, t: rlm.decode_step(p, cfg_ref, c, t))
    last_logits = None
    for i in range(max(len(p) for p in prompts)):
        toks = np.array([[p[i] if i < len(p) else 0] for p in prompts],
                        np.int32)
        last_logits, cache = decode(params, cache, jnp.asarray(toks))
    want = [[] for _ in range(batch)]
    tok = jnp.argmax(last_logits[..., :cfg_ref.vocab], axis=-1).astype(jnp.int32)
    for _ in range(n_new):
        for b in range(batch):
            want[b].append(int(tok[b, 0]))
        logits, cache = decode(params, cache, tok)
        tok = jnp.argmax(logits[..., :cfg_ref.vocab], axis=-1).astype(jnp.int32)

    model = params_from_numpy(reduced(get_config("jamba-v0.1-52b")),
                              jax.tree.map(np.asarray, params), device="cpu")
    assert serve(model, prompts, n_new, max_cache)["tokens"] == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_numpy_carries_every_leaf(arch):
    rcfg, params, cfg, model = _models(arch)
    tree = jax.tree.map(np.asarray, params)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for _, x in leaves)
    state = model.state_dict()
    n_prefix, period = cfg.first_dense_layers, model.period
    for path, x in leaves:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "prefix":
            name, x = ".".join(["blocks", str(keys[1])] + keys[2:]), [x]
        elif keys[0] == "stack":
            j = int(keys[1][3:])
            name = ".".join(["blocks", "{}"] + keys[2:])
            x = [(name.format(n_prefix + i * period + j), x[i])
                 for i in range(x.shape[0])]
        else:
            name, x = keys[0], [x]
        for item in x:
            key, value = item if isinstance(item, tuple) else (name, item)
            # dt_bias is float64 in the reference's tree where x64 is on
            np.testing.assert_array_equal(_np(state[key]),
                                          np.asarray(value, np.float32))
    for blk in model.blocks:
        assert hasattr(blk, "ln2") == (blk.kind.ffn != "none")
        if blk.kind.ffn == "moe":
            assert blk.ffn.router.dtype == torch.float32
        if blk.kind.mixer == "mamba":
            assert blk.mamba.a_log.dtype == torch.float32


@pytest.mark.parametrize("arch,break_it,match", [
    ("falcon-mamba-7b", lambda t: t["stack"]["sub0"].update(
        ln2=t["stack"]["sub0"]["ln1"]), "ln2"),
    ("jamba-v0.1-52b", lambda t: t["stack"]["sub3"]["ffn"].pop("router"),
     "router"),
    ("deepseek-v2-lite-16b", lambda t: t["prefix"].clear(), "prefix"),
    ("jamba-v0.1-52b", lambda t: t["stack"].pop("sub7"), "sub7"),
    ("deepseek-v2-lite-16b", lambda t: t["stack"]["sub0"]["attn"].update(
        wuk=t["stack"]["sub0"]["attn"]["wuk"][:, :, :8]), "wuk"),
    ("phi3.5-moe-42b-a6.6b", lambda t: t["stack"]["sub0"]["ffn"].update(
        wg=t["stack"]["sub0"]["ffn"]["wg"][:, :4]), "wg"),
])
def test_params_from_numpy_rejects_a_wrong_tree(arch, break_it, match):
    rcfg = ref_reduced(ref_get_config(arch))
    tree = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(0), rcfg))
    break_it(tree)
    with pytest.raises(ValueError, match=match):
        params_from_numpy(reduced(get_config(arch)), tree, device="cpu")
