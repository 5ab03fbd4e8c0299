"""The port's encoder-decoder (whisper) and VLM (llava) families against the
JAX package, on the CPU, at reduced size.

The same parameters (the reference's ``init_params`` tree, its norm-like
leaves perturbed so that they matter, carried across with
``params_from_numpy``), the same tokens, frames and patch embeddings go
through both packages; the reference runs jitted.  Tolerances: float32
within 2e-4, bfloat16 within 3e-2 (those of ``test_torch_models.py``),
greedy tokens exactly.  In bfloat16 the two frameworks' matmuls and
attention sums, taken in other orders, now and then round an element to
the neighbouring bf16 value, and the layers carry it on (ROADMAP.md, queue
3): where they do not, the results are equal bit for bit.
"""
import dataclasses

import repro.relational.table  # noqa: F401 — turns x64 on, as other files do
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import layers as RL
from repro.models import lm as rlm
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve_lm import serve, workload_frames

torch.set_num_threads(1)

WHISPER, LLAVA = "whisper-medium", "llava-next-mistral-7b"
F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
PERTURBED = {"ln1", "ln2", "ln", "final_norm"}


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


def _models(arch, dtype="float32", seed=0, perturb=True, **changes):
    """(reference cfg, reference params, port cfg, port model)."""
    rcfg, cfg = _cfgs(arch, dtype, **changes)
    tree = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(seed),
                                                    rcfg))
    if perturb:
        tree = _perturb(tree, np.random.default_rng(seed))
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(cfg, tree, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, vocab, tol):
    np.testing.assert_allclose(_np(got)[..., :vocab], _np(want)[..., :vocab],
                               **tol)


def _inputs(cfg, b=2, s=10, seed=7):
    """Tokens, targets and the family's frames or patch embeddings (numpy,
    float32)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
           "targets": rng.integers(0, cfg.vocab, (b, s))}
    if cfg.n_img_tiles:
        out["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tiles * cfg.img_patches, cfg.d_model)
        ).astype(np.float32)
    if cfg.enc_layers:
        out["frames"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _ref_hidden(rcfg, params, inp):
    fn = jax.jit(lambda p, t, i, f: rlm.forward(p, rcfg, t, img_embeds=i,
                                                frames=f))
    return fn(params, jnp.asarray(inp["tokens"]),
              None if "img_embeds" not in inp else jnp.asarray(inp["img_embeds"]),
              None if "frames" not in inp else jnp.asarray(inp["frames"]))


def _port_hidden(model, inp):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return model.forward(t["tokens"], t.get("img_embeds"), t.get("frames"))


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_configs_equal_the_reference(arch):
    ref, mine = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced(mine)) == dataclasses.asdict(
        ref_reduced(ref))
    assert mine.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_params_from_numpy_carries_every_leaf(arch):
    rcfg, params, cfg, model = _models(arch)
    tree = jax.tree.map(np.asarray, params)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(tree))
    if cfg.enc_layers:
        np.testing.assert_array_equal(model.enc_pos.numpy(), tree["enc_pos"])
        np.testing.assert_array_equal(model.dec_pos.numpy(), tree["dec_pos"])
        assert model.dec_pos.shape == (lm.DEC_POS_ROWS, cfg.d_model)
        assert model.dec_pos.dtype == model.enc_pos.dtype == torch.float32
        for i, layer in enumerate(model.enc):
            for key, p in layer.named_parameters():
                sub = tree["enc"]
                for part in key.split("."):
                    sub = sub[part]
                np.testing.assert_array_equal(p.numpy(), sub[i])
        for i, cross in enumerate(model.cross):
            np.testing.assert_array_equal(cross.ln.numpy(),
                                          tree["cross"]["ln"][i])
            for key, p in cross.attn.named_parameters():
                np.testing.assert_array_equal(p.numpy(),
                                              tree["cross"]["attn"][key][i])
    else:
        assert not hasattr(model, "enc") and not hasattr(model, "cross")


@pytest.mark.parametrize("break_it,match", [
    (lambda t: t.pop("enc"), "enc"),
    (lambda t: t.pop("dec_pos"), "dec_pos"),
    (lambda t: t.update(cross={k: v for k, v in t["cross"].items()
                               if k != "ln"}), "ln"),
    (lambda t: t.update(enc=jax.tree.map(lambda a: a[:1], t["enc"])),
     "stacked layers"),
    (lambda t: t.update(enc_pos=t["enc_pos"][:, :8]), "enc_pos"),
])
def test_params_from_numpy_rejects_a_wrong_whisper_tree(break_it, match):
    rcfg, cfg = _cfgs(WHISPER)
    tree = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(0), rcfg))
    break_it(tree)
    with pytest.raises(ValueError, match=match):
        params_from_numpy(cfg, tree, device="cpu")


def test_params_from_numpy_rejects_whisper_leaves_on_another_config():
    rcfg, _ = _cfgs(WHISPER)
    tree = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(0), rcfg))
    other = jax.tree.map(np.asarray, rlm.init_params(
        jax.random.PRNGKey(0), ref_reduced(ref_get_config("llama3.2-3b"))))
    other["dec_pos"] = tree["dec_pos"]
    with pytest.raises(ValueError, match="dec_pos"):
        params_from_numpy(reduced(get_config("llama3.2-3b")), other,
                          device="cpu")


def test_masters_are_float32_whatever_the_compute_dtype():
    rcfg, cfg = _cfgs(WHISPER, "bfloat16")
    tree = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(0), rcfg))
    model = params_from_numpy(cfg, tree, device="cpu", dtype=torch.float32)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_array_equal(model.enc[1].ffn.w1.numpy(),
                                  tree["enc"]["ffn"]["w1"][1])
    served = params_from_numpy(cfg, tree, device="cpu")
    assert served.enc[1].ffn.w1.dtype == torch.bfloat16
    assert served.dec_pos.dtype == torch.float32


# ---------------------------------------------------------------------------
# gelu, the encoder, cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax_bit_for_bit(dtype):
    """``layers.gelu`` follows XLA's rounding of ``jax.nn.gelu``: each step
    rounded to the input's dtype, the constants first.  ``F.gelu``, which
    rounds once, departs in bf16 on about two values in five."""
    x = (np.random.default_rng(0).standard_normal(1 << 14) * 3).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = _np(jax.jit(jax.nn.gelu)(xj))
    xt = torch.tensor(_np(xj)).to(getattr(torch, dtype))
    got = L.gelu(xt)
    assert got.dtype == xt.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), want)
        once = _np(F.gelu(xt, approximate="tanh"))
        assert (once != want).mean() > 0.3
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(dtype):
    """frames (B,S_enc,d) through the non-causal encoder; bf16 to within one
    bf16 ulp of the output's scale where a sum rounds the other way."""
    rcfg, params, cfg, model = _models(WHISPER, dtype)
    fr = _inputs(cfg)["frames"]
    want = jax.jit(lambda p, f: rlm._encoder(p, rcfg, f))(params, jnp.asarray(fr))
    got = model.encode(torch.from_numpy(fr))
    assert got.shape == (2, cfg.enc_seq, cfg.d_model) and got.dtype == model.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_encoder_attention_pads_1500_rows_to_its_kv_block():
    """whisper-medium's 1,500 frames are not a multiple of the 1,024-row kv
    block: the non-causal attention pads q and kv and masks the padding, as
    the reference does."""
    rcfg, cfg = _cfgs(WHISPER, d_model=32, n_heads=2, n_kv_heads=2,
                      head_dim=16, enc_seq=1500)
    p = RL.init_attention(jax.random.PRNGKey(5), rcfg)
    mod = L.Attention(cfg, torch.Generator(), "cpu", torch.float32)
    for key, param in mod.named_parameters():
        param.data.copy_(torch.tensor(np.asarray(p[key])))
    x = np.random.default_rng(5).normal(size=(1, 1500, 32)).astype(np.float32)
    want = jax.jit(lambda p, x: RL.attention_train(p, rcfg, x, causal=False))(
        p, jnp.asarray(x))
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x), causal=False)),
                               _np(want), **F32_TOL)


def test_bf16_cross_attention_norm_reads_the_block_sum():
    """In the reference's scan step a decoder block and its cross-attention
    are one compiled step: the cross-attention's norm reads the block's
    float32 residual sum unrounded, the next block the rounded carry.  One
    decoder layer in bf16 (the reference's initial tree) equals the
    reference bit for bit; the same layer with the cross-attention reading
    the rounded sum does not."""
    rcfg, params, cfg, model = _models(WHISPER, "bfloat16", perturb=False,
                                       n_layers=1, enc_layers=1)
    inp = _inputs(cfg)
    want = _np(_ref_hidden(rcfg, params, inp))
    np.testing.assert_array_equal(_np(_port_hidden(model, inp)), want)
    cross = model.cross[0]
    rounded = type(cross).forward
    try:
        type(cross).forward = lambda self, x, x32, e: rounded(self, x, None, e)
        assert (_np(_port_hidden(model, inp)) != want).any()
    finally:
        type(cross).forward = rounded


# ---------------------------------------------------------------------------
# the model: forward, prefill, loss, decode_step
# ---------------------------------------------------------------------------


CASES = [(WHISPER, "float32"), (WHISPER, "bfloat16"), (LLAVA, "float32"),
         (LLAVA, "bfloat16")]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_prefill_and_loss_match(arch, dtype):
    rcfg, params, cfg, model = _models(arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    inp = _inputs(cfg)
    b, s = inp["tokens"].shape
    want = rlm.logits_fn(params, rcfg, _ref_hidden(rcfg, params, inp))
    hidden = _port_hidden(model, inp)
    n_img = cfg.n_img_tiles * cfg.img_patches
    assert hidden.shape == (b, n_img + s, cfg.d_model)
    _close(model.logits_fn(hidden), want, cfg.vocab, tol)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    _close(model.prefill(t["tokens"], t.get("img_embeds"), t.get("frames")),
           want[:, -1:], cfg.vocab, tol)
    # a few targets ignored (< 0): the mean runs over the rest
    inp["targets"][0, :3] = -1
    t["targets"] = torch.from_numpy(inp["targets"])
    jb = {k: jnp.asarray(v) for k, v in inp.items()}
    loss_ref = jax.jit(lambda p, b: rlm.loss_fn(p, rcfg, b))(params, jb)
    loss = model.loss_fn(t)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(loss_ref),
                               **(F32_TOL if dtype == "float32"
                                  else dict(rtol=1e-2)))


def test_loss_of_all_ignored_targets_is_zero():
    rcfg, params, cfg, model = _models(LLAVA)
    inp = _inputs(cfg)
    inp["targets"][:] = -5
    jb = {k: jnp.asarray(v) for k, v in inp.items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    assert float(model.loss_fn(t)) == float(rlm.loss_fn(params, rcfg, jb)) == 0.0


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_step_matches(arch, dtype):
    """Teacher-forced decode steps (whisper with the encoder output in the
    cache, learned positions per row; llava over tokens only) against the
    reference's, and the caches after them."""
    rcfg, params, cfg, model = _models(arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    inp = _inputs(cfg)
    toks = inp["tokens"]
    b, steps, cache_len = toks.shape[0], 6, 16
    cache_ref = rlm.init_cache(rcfg, b, cache_len)
    cache = model.init_cache(b, cache_len)
    if cfg.enc_layers:
        assert cache["enc_out"].shape == (b, cfg.enc_seq, cfg.d_model)
        assert cache["enc_out"].dtype == model.dtype
        cache_ref["enc_out"] = jax.jit(lambda p, f: rlm._encoder(p, rcfg, f))(
            params, jnp.asarray(inp["frames"]))
        cache["enc_out"] = model.encode(torch.from_numpy(inp["frames"]))
    else:
        assert "enc_out" not in cache
    step = jax.jit(lambda p, c, t: rlm.decode_step(p, rcfg, c, t))
    for i in range(steps):
        t = toks[:, i:i + 1]
        lg_ref, cache_ref = step(params, cache_ref, jnp.asarray(t))
        lg, cache = model.decode_step(cache, torch.from_numpy(t))
        _close(lg, lg_ref, cfg.vocab, tol)
    np.testing.assert_array_equal(cache["length"].numpy(),
                                  np.asarray(cache_ref["length"]))
    for i, c in enumerate(cache["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                _np(c[key]), _np(cache_ref["stack"]["sub0"][key][i]), **tol)


def test_decode_positions_clip_to_the_table():
    """A row whose fill is past the 32,768 learned positions reads the last
    one, as the reference's ``clip`` does."""
    rcfg, params, cfg, model = _models(WHISPER)
    inp = _inputs(cfg)
    cache_ref = rlm.init_cache(rcfg, 2, 4)
    cache = model.init_cache(2, 4)
    cache_ref["enc_out"] = rlm._encoder(params, rcfg, jnp.asarray(inp["frames"]))
    cache["enc_out"] = model.encode(torch.from_numpy(inp["frames"]))
    length = np.array([lm.DEC_POS_ROWS + 5, 3], np.int32)
    cache_ref["length"] = jnp.asarray(length)
    cache["length"] = torch.from_numpy(length)
    t = inp["tokens"][:, :1]
    want, _ = rlm.decode_step(params, rcfg, cache_ref, jnp.asarray(t))
    got, _ = model.decode_step(cache, torch.from_numpy(t))
    _close(got, want, cfg.vocab, F32_TOL)


def test_decode_matches_forward_incrementally():
    """The reference's own check on whisper: teacher-forced decode logits
    (decode attention through the kernel wrapper, cross-attention over the
    cached encoder output) equal the parallel forward's."""
    _, _, cfg, model = _models(WHISPER, seed=2)
    inp = _inputs(cfg, b=1, s=8)
    toks = torch.from_numpy(inp["tokens"])
    frames = torch.from_numpy(inp["frames"])
    full = model.logits_fn(model.forward(toks, frames=frames))
    cache = model.init_cache(1, 9)
    cache["enc_out"] = model.encode(frames)
    outs = [model.decode_step(cache, toks[:, i:i + 1])[0][:, 0]
            for i in range(8)]
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               rtol=2e-3, atol=2e-3)


def test_vlm_image_prefix_is_causal_and_may_be_empty():
    """The image rows' hidden states do not depend on the text after them;
    an empty (B,0,d) prefix gives the text-only backbone, as the
    reference's concatenation does."""
    rcfg, params, cfg, model = _models(LLAVA)
    inp = _inputs(cfg)
    n_img = cfg.n_img_tiles * cfg.img_patches
    h1 = _port_hidden(model, inp)
    other = dict(inp, tokens=(inp["tokens"] + 1) % cfg.vocab)
    h2 = _port_hidden(model, other)
    np.testing.assert_array_equal(_np(h1[:, :n_img]), _np(h2[:, :n_img]))
    assert (_np(h1[:, n_img:]) != _np(h2[:, n_img:])).any()
    empty = dict(inp, img_embeds=np.zeros((2, 0, cfg.d_model), np.float32))
    want = _ref_hidden(rcfg, params, empty)
    got = _port_hidden(model, empty)
    assert got.shape == (2, inp["tokens"].shape[1], cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("arch,missing", [(WHISPER, "frames"),
                                          (LLAVA, "img_embeds")])
def test_forward_needs_the_modality_inputs(arch, missing):
    _, _, cfg, model = _models(arch)
    with pytest.raises(ValueError, match=missing[:3]):
        model.forward(torch.from_numpy(_inputs(cfg)["tokens"]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _reference_serve(params, cfg, prompts, n_new, max_cache, frames=None):
    """The reference's serving loop (examples/serve_lm.py), the encoder's
    output in the cache first as ``tests/test_models.py::test_smoke_decode``
    puts it."""
    batch = len(prompts)
    cache = rlm.init_cache(cfg, batch, max_cache)
    if frames is not None:
        cache["enc_out"] = rlm._encoder(params, cfg, jnp.asarray(frames))
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


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_serve_gives_the_reference_greedy_tokens(arch):
    rcfg, params, cfg, model = _models(arch, seed=6)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 3, 7)]
    frames = workload_frames(cfg, len(prompts)) if cfg.enc_layers else None
    want = _reference_serve(params, rcfg, prompts, 8, 32, frames)
    result = serve(model, prompts, n_new=8, max_cache=32, frames=frames)
    assert result["tokens"] == want
    if cfg.enc_layers:
        with pytest.raises(ValueError, match="frames"):
            serve(model, prompts, n_new=1, max_cache=32)


def test_workload_frames_come_from_the_seed():
    cfg = get_config(WHISPER)
    a, b = workload_frames(cfg, 2), workload_frames(cfg, 2)
    assert a.shape == (2, 1500, 1024) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
