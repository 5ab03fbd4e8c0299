"""The port's training stack against the JAX package, on the CPU: ``loss_fn``
and one train step of each of the ten configurations at reduced size,
AdamW and its schedule, int8 gradient compression with error feedback,
``psum_compressed`` on a ``ShardMesh``, and the example trainer.

Tolerances.  Float32: the loss within 2e-4; the gradient norm within 2e-5
relative; each leaf of the first moment (0.1 x the clipped gradient) within
2e-5 of its norm (read up to 9.3e-6, jamba's ``a_log``, whose gradient is
tiny).  The new parameters within a quarter of the step's learning rate:
AdamW's first step moves an element by lr * g / (|g| + eps), and where a
clipped gradient element is near eps (1e-8) the float32 noise of the two
frameworks' sums in g moves that by a share of lr (read up to 0.103 lr).
The optimizer on the same gradients: within an ulp or two of float32.
"""
import dataclasses
import importlib.util
from pathlib import Path

import repro.relational.table  # noqa: F401 — turns x64 on, as other files do
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as ref_all_configs
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import lm as rlm
from repro.training import optimizer as RO
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch import serve_lm, train_lm
from repro_torch.configs import get_config, reduced
from repro_torch.exchange.service import ShardMesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import (decayed, init_train_state,
                                             make_train_step)

torch.set_num_threads(1)

ARCHS = sorted(ref_all_configs())
ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _batch(cfg, b=2, s=32, seed=0):
    """tests/test_models.py's ``_batch``: the same draws in the same order."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
             "targets": rng.integers(0, cfg.vocab, (b, s))}
    if cfg.n_img_tiles:
        n = cfg.n_img_tiles * cfg.img_patches
        batch["img_embeds"] = rng.normal(size=(b, n, cfg.d_model)).astype(
            np.float32)
    if cfg.enc_layers:
        batch["frames"] = rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def _named(cfg, tree):
    """A reference tree (params or a moment) by the port's parameter names."""
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, tree),
                              device="cpu", dtype=torch.float32)
    return {k: v.detach() for k, v in model.named_parameters()}


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _step_pair(arch, dtype="float32"):
    """One train step of ``arch`` (reduced) in both packages from the same
    parameters and batch: (port cfg, old masters, port state, port metrics
    with the gradients, reference state, reference metrics, port step)."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    tree = jax.tree.map(np.asarray, rlm.init_params(jax.random.PRNGKey(0), rcfg))
    params = jax.tree.map(jnp.asarray, tree)
    batch = _batch(cfg)
    ref_state = {"params": params, "opt": RO.init_opt_state(params)}
    ref_step = jax.jit(ref_make_train_step(
        rcfg, RO.OptConfig(warmup_steps=1, total_steps=10)))
    ref_state, ref_metrics = ref_step(ref_state,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    state = init_train_state(cfg, model=params_from_numpy(
        cfg, tree, device="cpu", dtype=torch.float32))
    old = {k: v.clone() for k, v in state["params"].items()}
    step = make_train_step(cfg, O.OptConfig(warmup_steps=1, total_steps=10),
                           device="cpu")
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, keep_grads=True)
    return cfg, old, state, metrics, ref_state, ref_metrics, step


# ---------------------------------------------------------------------------
# the train step of every configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    cfg, old, state, metrics, ref_state, ref_metrics, _ = _step_pair(arch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and 3.0 < loss < 12.0
    np.testing.assert_allclose(loss, float(ref_metrics["loss"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(ref_metrics["grad_norm"]), rtol=2e-5)
    assert int(state["opt"]["step"]) == int(ref_state["opt"]["step"]) == 1
    for moment in ("mu", "nu"):
        want = _named(cfg, ref_state["opt"][moment])
        assert set(want) == set(state["opt"][moment])
        for k, w in want.items():
            if float(w.norm()) > 0:
                assert _rel(state["opt"][moment][k], w) < 2e-5, (moment, k)
            else:
                assert float(state["opt"][moment][k].abs().max()) == 0, k
    lr = float(RO.lr_schedule(RO.OptConfig(warmup_steps=1, total_steps=10), 1))
    new = _named(cfg, ref_state["params"])
    for k, w in new.items():
        np.testing.assert_allclose(_np(state["params"][k]), _np(w),
                                   rtol=1e-6, atol=0.25 * lr, err_msg=k)
    assert float((state["params"]["embed"] - old["embed"]).abs().max()) > 0


def test_bf16_train_step_keeps_float32_masters_and_casts_at_use():
    """Reduced llama3.2-3b in bf16: the masters and moments stay float32;
    the working copy holds matmul weights and norms in bf16 and the
    embedding float32 (as the reference casts at use), so its gradients
    come out bf16 and float32; the loss, the gradient norm and the first
    moment agree with the reference's bf16 step within the bf16
    tolerance, 3e-2."""
    cfg, old, state, metrics, ref_state, ref_metrics, step = _step_pair(
        "llama3.2-3b", "bfloat16")
    model = step.model
    assert model.embed.dtype == torch.float32
    assert model.blocks[0].attn.wq.dtype == model.blocks[0].ln1.dtype == \
        torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state["params"].values())
    assert all(m.dtype == torch.float32 for m in state["opt"]["mu"].values())
    grads = metrics["grads"]
    assert set(grads) == set(state["params"])
    assert grads["embed"].dtype == torch.float32
    assert grads["blocks.0.ffn.wg"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref_metrics["loss"]), rtol=3e-2)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(ref_metrics["grad_norm"]), rtol=3e-2)
    want = _named(cfg, ref_state["opt"]["mu"])
    for k, w in want.items():
        assert _rel(state["opt"]["mu"][k], w) < 3e-2, k
    new = _named(cfg, ref_state["params"])
    for k, w in new.items():
        np.testing.assert_allclose(_np(state["params"][k]), _np(w),
                                   rtol=3e-2, atol=3e-2, err_msg=k)


def test_decay_follows_the_reference_tree():
    """The reference decays its leaves of two or more dimensions, and a
    layer stack's leaves carry the layer axis: deepseek's dense prefix
    block keeps its norms undecayed, the stacked blocks' norms are decayed,
    ``final_norm`` is not; whisper's encoder and cross-attention norms are
    stacked."""
    model = make_train_step(reduced(get_config("deepseek-v2-lite-16b")),
                            device="cpu").model
    names = decayed(model)
    assert "blocks.0.ln1" not in names and "blocks.0.attn.kv_norm" not in names
    assert "blocks.0.attn.wq" in names
    assert {"blocks.1.ln1", "blocks.1.attn.kv_norm", "embed"} <= names
    assert "final_norm" not in names
    whisper = make_train_step(reduced(get_config("whisper-medium")),
                              device="cpu").model
    assert {"enc.0.ln1", "cross.3.ln", "dec_pos", "enc_pos"} <= decayed(whisper)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------


def test_lr_schedule_matches():
    for cfg_kw in ({}, dict(warmup_steps=10, total_steps=200, lr=3e-3),
                   dict(warmup_steps=0, total_steps=0)):
        for step in (0, 1, 5, 10, 11, 100, 150, 199, 200, 10_000, 20_000):
            want = float(RO.lr_schedule(RO.OptConfig(**cfg_kw),
                                        jnp.asarray(step, jnp.int32)))
            got = float(O.lr_schedule(O.OptConfig(**cfg_kw),
                                      torch.tensor(step, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _random_tree(rng):
    """Leaves of one, two and three dimensions, with gradients down near
    eps and exact zeros."""
    shapes = {"norm": (16,), "w": (12, 8), "stack": (3, 4, 5)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for _ in range(3):
        g = {k: (rng.normal(size=s) * np.exp(rng.uniform(-8, 2, size=s)))
             .astype(np.float32) for k, s in shapes.items()}
        g["w"][0] = 0.0
        grads.append(g)
    return params, grads


def test_global_norm_matches():
    _, grads = _random_tree(np.random.default_rng(1))
    want = float(RO.global_norm({k: jnp.asarray(v) for k, v in grads[0].items()}))
    got = float(O.global_norm({k: torch.from_numpy(v) for k, v in grads[0].items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_the_reference(clip):
    """Three steps on the same gradients (clipped or not): the moments and
    the parameters within an ulp or two of float32 (the reference with x64
    on takes the bias-corrected step in float64), the norm alike."""
    params, grads = _random_tree(np.random.default_rng(2))
    rcfg = RO.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip)
    cfg = O.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = RO.init_opt_state(rp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = O.init_opt_state(tp)
    update = jax.jit(lambda p, g, s: RO.adamw_update(p, g, s, rcfg))
    for g in grads:
        rp, rs, rn = update(rp, {k: jnp.asarray(v) for k, v in g.items()}, rs)
        tp, ts, tn = O.adamw_update(tp, {k: torch.from_numpy(v)
                                         for k, v in g.items()}, ts, cfg)
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
        for k in params:
            for m in ("mu", "nu"):       # the clip scale differs by an ulp
                want = _np(rs[m][k])
                np.testing.assert_allclose(ts[m][k].numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())
            np.testing.assert_allclose(tp[k].numpy(), _np(rp[k]),
                                       rtol=3e-7, atol=1e-9)
    assert int(ts["step"]) == int(rs["step"]) == 3


def test_adamw_update_decays_the_named_leaves_only():
    p = {"a": torch.ones(4), "b": torch.ones(2, 2)}
    g = {"a": torch.zeros(4), "b": torch.zeros(2, 2)}
    cfg = O.OptConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    O.adamw_update(p, g, O.init_opt_state(p), cfg)        # default: ndim >= 2
    assert float(p["a"][0]) == 1.0 and float(p["b"][0, 0]) < 1.0
    p = {"a": torch.ones(4), "b": torch.ones(2, 2)}
    O.adamw_update(p, g, O.init_opt_state(p), cfg, decay={"a"})
    assert float(p["a"][0]) < 1.0 and float(p["b"][0, 0]) == 1.0


def test_adamw_update_works_in_chunks(monkeypatch):
    """A leaf larger than the chunk is updated piece by piece, to the same
    values."""
    params, grads = _random_tree(np.random.default_rng(3))
    cfg = O.OptConfig(lr=1e-2, warmup_steps=1)
    outs = []
    for chunk in (1 << 26, 7):
        monkeypatch.setattr(O, "_CHUNK", chunk)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ts = O.init_opt_state(tp)
        O.adamw_update(tp, {k: torch.from_numpy(v) for k, v in grads[0].items()},
                       ts, cfg)
        outs.append(tp)
    for k in params:
        np.testing.assert_array_equal(outs[0][k].numpy(), outs[1][k].numpy())


def test_adamw_converges_on_quadratic():
    """tests/test_models.py's case on the port."""
    params = {"w": torch.tensor([5.0, -3.0])}
    state = O.init_opt_state(params)
    cfg = O.OptConfig(lr=0.3, warmup_steps=1, total_steps=200, weight_decay=0.0)
    for _ in range(150):
        params, state, _ = O.adamw_update(params, {"w": 2 * params["w"]},
                                          state, cfg)
    assert float(params["w"].abs().max()) < 0.3


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------


def test_compress_int8_matches():
    rng = np.random.default_rng(4)
    for g in (rng.normal(size=1000), rng.normal(size=(7, 33)) * 1e-5,
              np.zeros(5)):
        g = g.astype(np.float32)
        q_ref, s_ref = jax.jit(RO.compress_int8)(jnp.asarray(g))
        q, s = O.compress_int8(torch.from_numpy(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        assert float(s) == float(s_ref)
        np.testing.assert_allclose(O.decompress_int8(q, s).numpy(),
                                   _np(RO.decompress_int8(q_ref, s_ref)),
                                   rtol=1e-6, atol=1e-12)


def test_int8_gradient_compression_error_feedback():
    """tests/test_models.py's case on the port."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,))
                         .astype(np.float32))
    q, scale = O.compress_int8(g)
    deq = O.decompress_int8(q, scale)
    assert float((deq - g).norm() / g.norm()) < 0.01
    err = torch.zeros_like(g)
    acc_plain = torch.zeros_like(g)
    acc_comp = torch.zeros_like(g)
    for _ in range(50):
        g32 = g + err
        q, scale = O.compress_int8(g32)
        deq = O.decompress_int8(q, scale)
        err = g32 - deq
        acc_comp = acc_comp + deq
        acc_plain = acc_plain + g
    assert float((acc_comp - acc_plain).abs().max()) < 0.05


@pytest.mark.parametrize("n_shards", [1, 4])
def test_psum_compressed_matches_the_reference_under_vmap(n_shards):
    """Each shard's gradients (the leading axis) through two rounds of
    ``psum_compressed`` with error feedback, against the reference's under
    ``jax.vmap(..., axis_name="data")``: the reduced gradients (the same on
    every shard) and each shard's residual (within 1e-6 of the gradients'
    scale)."""
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 5), "b": (7,)}
    rounds = [{k: (rng.normal(size=(n_shards,) + s)
                   * rng.uniform(0.1, 10, size=(n_shards,) + (1,) * len(s)))
               .astype(np.float32) for k, s in shapes.items()}
              for _ in range(2)]
    ref = jax.jit(jax.vmap(lambda g, e: RO.psum_compressed(g, "data", e),
                           axis_name="data"))
    err_ref = {k: jnp.zeros((n_shards,) + s, jnp.float32) for k, s in shapes.items()}
    mesh = ShardMesh.of(n_shards, "cpu")
    err = O.init_error_state({k: torch.zeros((n_shards,) + s)
                              for k, s in shapes.items()})
    for g in rounds:
        red_ref, err_ref = ref({k: jnp.asarray(v) for k, v in g.items()}, err_ref)
        red, err = O.psum_compressed({k: torch.from_numpy(v) for k, v in g.items()},
                                     "data", err, mesh)
        for k in shapes:
            np.testing.assert_allclose(red[k].numpy(), _np(red_ref[k]),
                                       rtol=1e-6, atol=1e-9)
            # the residual g - q * scale: one multiply-add or two roundings,
            # as XLA fuses it, an ulp of the gradient's scale apart
            np.testing.assert_allclose(err[k].numpy(), _np(err_ref[k]),
                                       rtol=1e-6, atol=1e-6 * np.abs(g[k]).max())
            np.testing.assert_array_equal(red[k].numpy(),
                                          np.broadcast_to(red[k].numpy()[:1],
                                                          red[k].shape))


# ---------------------------------------------------------------------------
# the example trainer
# ---------------------------------------------------------------------------


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "_ref_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_config_and_stream_equal_the_reference():
    ref = _reference_example()
    assert dataclasses.asdict(train_lm.make_cfg()) == \
        dataclasses.asdict(ref.make_cfg())
    a = ref.synthetic_stream(97, 3, 16, seed=5)
    b = train_lm.synthetic_stream(97, 3, 16, seed=5)
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(y[k].numpy(), np.asarray(x[k]))
            assert y[k].dtype == torch.int64


def test_train_lm_runs_on_the_cpu_and_round_trips_its_checkpoint(tmp_path):
    out = train_lm.run(steps=3, batch=2, seq=16, device="cpu",
                       ckpt=str(tmp_path / "ckpt.npz"), log=lambda *_: None)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["checkpoint_max_abs_diff"] == 0.0
    assert out["checkpoint_step"] == 3 and (tmp_path / "ckpt.npz").exists()


# ---------------------------------------------------------------------------
# entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen3-4b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.run(steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--arch", "whisper-medium"])
    assert make_train_step(cfg, device="cpu").model.device.type == "cpu"
    assert init_train_state(cfg, device="cpu")["params"]["embed"].device.type \
        == "cpu"
