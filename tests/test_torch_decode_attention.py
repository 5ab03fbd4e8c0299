"""Decode attention of the port against the JAX package, on the CPU.

``decode_attention_ref`` (the plain version the CUDA kernel is held against
on the card, and what ``ops.decode_attention`` runs for CPU tensors) must
agree with ``repro.kernels.ref.decode_attention_ref`` and with the Pallas
``decode_attention`` in interpret mode at the reference's test shapes, with
the reference's tolerances (``tests/test_kernels.py``: 2e-5 in float32,
3e-2 in bfloat16).  Where the Pallas kernel and its jnp reference disagree
(``lengths`` <= 0 or > S), the port follows the jnp reference, which is what
the reference's ``attention_decode`` computes.
"""
import repro.relational.table  # noqa: F401 — turns x64 on, as other files do
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention_ref

torch.set_num_threads(1)


def _inputs(b, h, kvh, d, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    return q, k, v


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("h,kvh", [(8, 8), (8, 4), (32, 8), (16, 1)])
@pytest.mark.parametrize("s", [64, 700, 1536])
def test_plain_version_matches_ref_and_pallas(h, kvh, s):
    """The reference's test_decode_attention_shapes, through the port."""
    b, d = 2, 64
    q, k, v = _inputs(b, h, kvh, d, s, seed=h * s)
    lengths = np.array([s, max(s // 3, 1)], np.int32)
    got = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                               torch.from_numpy(lengths)).numpy()
    want = jax_ref.decode_attention_ref(_jax(q), _jax(k), _jax(v),
                                        jnp.asarray(lengths))
    pallas = ref_ops.decode_attention(_jax(q), _jax(k), _jax(v),
                                      jnp.asarray(lengths))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    # on CPU tensors the wrapper is its plain version
    plain = decode_attention_ref(_torch(q), _torch(k), _torch(v),
                                 torch.from_numpy(lengths))
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_dtypes(dtype):
    """The reference's test_decode_attention_dtypes: bfloat16 inputs give a
    bfloat16 output within 3e-2 of both JAX versions."""
    b, h, kvh, d, s = 1, 4, 2, 32, 300
    q, k, v = _inputs(b, h, kvh, d, s, seed=3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    lengths = np.array([s], np.int32)
    got = ops.decode_attention(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                               torch.from_numpy(lengths))
    assert got.dtype == tdt
    want = jax_ref.decode_attention_ref(_jax(q, jdt), _jax(k, jdt),
                                        _jax(v, jdt), jnp.asarray(lengths))
    pallas = ref_ops.decode_attention(_jax(q, jdt), _jax(k, jdt),
                                      _jax(v, jdt), jnp.asarray(lengths))
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, _f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _f32(pallas), rtol=tol, atol=tol)


def test_plain_version_ignores_padded_tail():
    """Entries at or beyond ``length`` do not affect the result."""
    b, h, kvh, d, s = 1, 4, 4, 32, 200
    q, k, v = _inputs(b, h, kvh, d, s, seed=5)
    lengths = torch.tensor([100], dtype=torch.int32)
    out1 = ops.decode_attention(_torch(q), _torch(k), _torch(v), lengths)
    k2, v2 = k.copy(), v.copy()
    k2[:, 100:] = 99.0
    v2[:, 100:] = -99.0
    out2 = ops.decode_attention(_torch(q), _torch(k2), _torch(v2), lengths)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6, atol=1e-6)
    pallas = ref_ops.decode_attention(_jax(q), _jax(k2), _jax(v2),
                                      jnp.asarray([100]))
    np.testing.assert_allclose(out1.numpy(), np.asarray(pallas),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("edge", ["zero", "past_end"])
def test_edges_follow_ref_not_pallas(edge):
    """``lengths = 0``: the jnp reference gives the mean of v over all S
    rows; the Pallas kernel, which pads S with zero rows to a multiple of
    512, gives their sum over the padded length.  ``lengths = S + 1``: the
    reference attends the S real rows; the kernel's zero padding rows pass
    its mask.  The port follows the reference at both (ROADMAP queue 3)."""
    b, h, kvh, d, s = 2, 8, 4, 32, 300
    q, k, v = _inputs(b, h, kvh, d, s, seed=11)
    lengths = np.array([0, 0] if edge == "zero" else [s + 1, s + 1], np.int32)
    got = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                               torch.from_numpy(lengths)).numpy()
    want = np.asarray(jax_ref.decode_attention_ref(
        _jax(q), _jax(k), _jax(v), jnp.asarray(lengths)))
    pallas = np.asarray(ref_ops.decode_attention(
        _jax(q), _jax(k), _jax(v), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.abs(got - pallas).max() > 1e-4
    if edge == "zero":                   # the uniform mean over all S rows
        mean = v.mean(axis=1).repeat(h // kvh, axis=1)
        np.testing.assert_allclose(got, mean, rtol=2e-5, atol=2e-5)
    else:                                # the same as lengths = S
        full = ops.decode_attention(_torch(q), _torch(k), _torch(v),
                                    torch.full((b,), s, dtype=torch.int32))
        np.testing.assert_array_equal(got, full.numpy())
