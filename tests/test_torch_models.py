"""The port's LM stack (dense family) against the JAX package, on the CPU.

The MoE, MLA, Mamba and hybrid families are held in
``test_torch_lm_families.py``.

The same parameters (the reference's ``init_params`` tree, with its norm
weights and biases perturbed so that they matter, carried across with
``params_from_numpy``) and the same tokens go through both packages.
Tolerances: float32 results within 2e-4 (the reference's own
``test_blockwise_attention_matches_naive`` tolerance; the two frameworks sum
matmuls in other orders), bfloat16 results within 3e-2 (the reference's
bfloat16 decode-attention tolerance), greedy tokens exactly.
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
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch import serve_lm
from repro_torch.serve_lm import random_prompts, serve, serve_metrics

torch.set_num_threads(1)

DENSE = ("llama3.2-3b", "qwen3-4b", "qwen2-7b", "qwen2-72b")
F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# leaves that init_params sets to ones or zeros
PERTURBED = {"ln1", "ln2", "final_norm", "q_norm", "k_norm", "bq", "bk", "bv"}


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    x = np.asarray(tree)
    if name in PERTURBED:
        x = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    return x


def _models(arch, dtype="float32", seed=0):
    """(reference cfg, reference params, port cfg, port model) with one
    perturbed parameter tree."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    tree = _perturb(rlm.init_params(jax.random.PRNGKey(seed), rcfg),
                    np.random.default_rng(seed))
    params = jax.tree.map(jnp.asarray, tree)
    return rcfg, params, cfg, params_from_numpy(cfg, tree, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _load(module, tree):
    for key, param in module.named_parameters():
        param.data.copy_(torch.tensor(np.asarray(tree[key])))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_equal_the_reference(arch):
    ref, mine = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced(mine)) == dataclasses.asdict(ref_reduced(ref))
    assert mine.param_count() == ref.param_count()
    assert mine.padded_vocab == ref.padded_vocab
    assert [dataclasses.asdict(s) for s in mine.shapes()] == \
        [dataclasses.asdict(s) for s in ref.shapes()]


def test_shape_set_and_registry():
    assert [dataclasses.asdict(s) for s in configs.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in ref_base.LM_SHAPES]
    assert sorted(configs.all_configs()) == sorted(ref_base.all_configs())


def _port_cfg(ref_cfg):
    """The port's ArchConfig with the reference config's fields (its MoE,
    Mamba and MLA sub-configs carried over as they are)."""
    return configs.ArchConfig(**{f.name: getattr(ref_cfg, f.name)
                                 for f in dataclasses.fields(ref_cfg)})


@pytest.mark.parametrize("arch", sorted(ref_base.all_configs()))
def test_layer_plan_matches_reference(arch):
    ref_cfg = ref_get_config(arch)
    cfg = _port_cfg(ref_cfg)
    assert [dataclasses.astuple(k) for k in lm.layer_plan(cfg)] == \
        [dataclasses.astuple(k) for k in rlm.layer_plan(ref_cfg)]
    assert lm._period_len(cfg) == rlm._period_len(ref_cfg)


def test_causal_lm_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.CausalLM(cfg)
    assert lm.CausalLM(cfg, device="cpu").embed.device.type == "cpu"


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-7b"])
def test_params_from_numpy_carries_every_weight(arch):
    rcfg, params, cfg, model = _models(arch)
    tree = jax.tree.map(np.asarray, params)
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(model.embed.numpy(), tree["embed"])
    if cfg.tie_embeddings:
        assert model.head is None
    else:
        np.testing.assert_array_equal(model.head.numpy(), tree["head"])
    sub = tree["stack"]["sub0"]
    for i, block in enumerate(model.blocks):
        np.testing.assert_array_equal(block.ln1.numpy(), sub["ln1"][i])
        for key, p in block.attn.named_parameters():
            np.testing.assert_array_equal(p.numpy(), sub["attn"][key][i])
        for key, p in block.ffn.named_parameters():
            np.testing.assert_array_equal(p.numpy(), sub["ffn"][key][i])


def test_params_from_numpy_rejects_a_wrong_shape():
    rcfg = ref_reduced(ref_get_config("llama3.2-3b"))
    tree = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(0), rcfg))
    tree["stack"]["sub0"]["attn"]["wq"] = tree["stack"]["sub0"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(reduced(get_config("llama3.2-3b")), tree, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = L.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w), 1e-6)
    want = RL.rmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(w), 1e-6)
    assert got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(L.rope_freqs(128, 500_000.0)),
                               _np(RL.rope_freqs(128, 500_000.0)), rtol=1e-6)


@pytest.mark.parametrize("causal,sq,skv,h,kvh,bq,bk", [
    (True, 256, 256, 8, 4, 64, 64),        # the reference's naive-check case
    (True, 100, 100, 4, 2, 32, 48),        # q and kv padded
    (False, 64, 100, 4, 4, 32, 32),        # cross-attention, unequal lengths
    (True, 40, 40, 6, 2, 512, 1024),       # one block (the model's forward)
])
def test_blockwise_attention_matches(causal, sq, skv, h, kvh, bq, bk):
    rng = np.random.default_rng(sq + skv)
    b, d = 2, 32
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, kvh, d)).astype(np.float32)
    got = L.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                block_q=bq, block_kv=bk)
    want = RL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=bq, block_kv=bk)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches(kind):
    rcfg = dataclasses.replace(ref_reduced(ref_get_config("llama3.2-3b")),
                               mlp_kind=kind)
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")), mlp_kind=kind)
    p = RL.init_mlp(jax.random.PRNGKey(3), rcfg)
    mod = L.MLP(cfg, torch.Generator(), "cpu", torch.float32)
    _load(mod, p)
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))),
                               _np(RL.mlp(p, rcfg, jnp.asarray(x))), **F32_TOL)


def _attention(arch, seed):
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    p = _perturb(RL.init_attention(jax.random.PRNGKey(seed), rcfg),
                 np.random.default_rng(seed))
    mod = L.Attention(cfg, torch.Generator(), "cpu", torch.float32)
    _load(mod, p)
    return rcfg, jax.tree.map(jnp.asarray, p), mod


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-4b", "qwen2-7b"])
def test_attention_train_matches(arch):
    rcfg, p, mod = _attention(arch, 4)
    x = np.random.default_rng(4).normal(size=(2, 12, 64)).astype(np.float32)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))),
                               _np(RL.attention_train(p, rcfg, jnp.asarray(x))),
                               **F32_TOL)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-4b", "qwen2-7b"])
def test_attention_decode_matches_including_a_full_cache(arch):
    """Lengths S-1, S and S+3 hit dynamic_update_slice's clamp: the write
    lands on row S-1 and the attention runs with length + 1 > S."""
    rcfg, p, mod = _attention(arch, 5)
    rng = np.random.default_rng(5)
    b, s = 4, 8
    hd, kvh = rcfg.resolved_head_dim, rcfg.n_kv_heads
    x = rng.normal(size=(b, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    cv = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    length = np.array([2, s - 1, s, s + 3], np.int32)
    o_ref, ck_ref, cv_ref = RL.attention_decode(
        p, rcfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(length))
    ck_t, cv_t = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    o = mod.decode(torch.from_numpy(x), ck_t, cv_t, torch.from_numpy(length))
    np.testing.assert_allclose(_np(o), _np(o_ref), **F32_TOL)
    np.testing.assert_allclose(ck_t.numpy(), _np(ck_ref), **F32_TOL)
    np.testing.assert_allclose(cv_t.numpy(), _np(cv_ref), **F32_TOL)
    # rows other than the written one are untouched
    written = np.minimum(length, s - 1)
    for i in range(b):
        keep = np.arange(s) != written[i]
        np.testing.assert_array_equal(ck_t.numpy()[i, keep], ck[i, keep])


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [("llama3.2-3b", "float32"),
                                        ("qwen3-4b", "float32"),
                                        ("qwen2-7b", "float32"),
                                        ("llama3.2-3b", "bfloat16")])
def test_forward_prefill_and_decode_match(arch, dtype):
    rcfg, params, cfg, model = _models(arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    b, s, steps, cache_len = 2, 10, 6, 16
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (b, s))
    fwd = jax.jit(lambda p, t: rlm.logits_fn(p, rcfg, rlm.forward(p, rcfg, t)))
    want = fwd(params, jnp.asarray(toks))
    got = model.logits_fn(model.forward(torch.from_numpy(toks)))
    assert got.shape == (b, s, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got)[..., :cfg.vocab],
                               _np(want)[..., :cfg.vocab], **tol)
    assert float(got[..., cfg.vocab:].max()) < -1e20
    np.testing.assert_allclose(
        _np(model.prefill(torch.from_numpy(toks)))[..., :cfg.vocab],
        _np(rlm.prefill(params, rcfg, jnp.asarray(toks)))[..., :cfg.vocab],
        **tol)

    step = jax.jit(lambda p, c, t: rlm.decode_step(p, rcfg, c, t))
    cache_ref = rlm.init_cache(rcfg, b, cache_len)
    cache = model.init_cache(b, cache_len)
    for i in range(steps):
        t = toks[:, i:i + 1]
        lg_ref, cache_ref = step(params, cache_ref, jnp.asarray(t))
        lg, cache = model.decode_step(cache, torch.from_numpy(t))
        np.testing.assert_allclose(_np(lg)[..., :cfg.vocab],
                                   _np(lg_ref)[..., :cfg.vocab], **tol)
    np.testing.assert_array_equal(cache["length"].numpy(),
                                  np.asarray(cache_ref["length"]))
    for i, c in enumerate(cache["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                _np(c[key]), _np(cache_ref["stack"]["sub0"][key][i]), **tol)


def test_decode_matches_forward_incrementally():
    """The reference's own check, on the port: teacher-forced decode logits
    equal the parallel forward's (decode attention through the kernel
    wrapper, forward through blockwise_attention)."""
    _, _, cfg, model = _models("qwen3-4b", seed=2)
    b, s = 1, 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (b, s)))
    full = model.logits_fn(model.forward(toks))
    cache = model.init_cache(b, s + 1)
    outs = []
    for i in range(s):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _reference_serve(params, cfg, prompts, n_new, max_cache):
    """The loop of the reference's examples/serve_lm.py."""
    batch = len(prompts)
    cache = rlm.init_cache(cfg, batch, max_cache)
    decode = jax.jit(lambda p, c, t: rlm.decode_step(p, cfg, c, t))
    last_logits = None
    for i in range(max(len(p) for p in prompts)):
        toks = np.array([[p[i] if i < len(p) else 0] for p in prompts],
                        np.int32)
        last_logits, cache = decode(params, cache, jnp.asarray(toks))
    out = [[] for _ in range(batch)]
    tok = jnp.argmax(last_logits[..., :cfg.vocab], axis=-1).astype(jnp.int32)
    for _ in range(n_new):
        for b in range(batch):
            out[b].append(int(tok[b, 0]))
        logits, cache = decode(params, cache, tok)
        tok = jnp.argmax(logits[..., :cfg.vocab], axis=-1).astype(jnp.int32)
    return out


def test_serve_gives_the_reference_greedy_tokens():
    rcfg, params, cfg, model = _models("llama3.2-3b", seed=6)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 3, 7)]
    want = _reference_serve(params, rcfg, prompts, n_new=8, max_cache=32)
    result = serve(model, prompts, n_new=8, max_cache=32)
    assert result["tokens"] == want
    assert result["prompt_tokens"] == 24 and result["prefill_steps"] == 9
    assert len(result["step_s"]) == 8
    metrics = serve_metrics(result)
    assert metrics["decode_tokens_per_s"] > 0 and metrics["median_step_ms"] > 0


def test_random_prompts_draw_lengths_in_range():
    prompts = random_prompts(np.random.default_rng(1), 8, 64, 512, 128_256)
    assert len(prompts) == 8
    assert all(64 <= len(p) <= 512 for p in prompts)
    assert all(0 <= int(t) < 128_256 for p in prompts for t in p)


def test_serving_workload_is_one_definition():
    """The workload's prompts come from its seed alone, the same on every
    call, at the reference example's batch and lengths."""
    vocab = get_config(serve_lm.ARCH).vocab
    prompts = serve_lm.workload_prompts(vocab)
    again = serve_lm.workload_prompts(vocab)
    assert len(prompts) == serve_lm.BATCH
    assert [list(p) for p in prompts] == [list(p) for p in again]
    lo, hi = serve_lm.PROMPT_LENS
    assert all(lo <= len(p) <= hi for p in prompts)
    assert all(0 <= int(t) < vocab for p in prompts for t in p)
