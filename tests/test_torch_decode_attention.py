"""Decode attention of the port against the JAX package, on the CPU.

``decode_attention_ref`` (the plain version the CUDA kernel is held against
on the card, and what ``ops.decode_attention`` runs for CPU tensors) must
agree with ``repro.kernels.ref.decode_attention_ref`` and with the Pallas
``decode_attention`` in interpret mode at the reference's test shapes, with
the reference's tolerances (``tests/test_kernels.py``: 2e-5 in float32,
3e-2 in bfloat16).  Where the Pallas kernel and its jnp reference disagree
(``lengths`` <= 0 or > S), the port follows the jnp reference, which is what
the reference's ``attention_decode`` computes.  The CUDA kernel's split of
the cache over blocks and its ordered combine are modelled in plain torch
and held against both references; the wrapper's split count is held at the
main path's shapes.
"""
import repro.relational.table  # noqa: F401 — turns x64 on, as other files do
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import build, ops
from repro_torch.kernels.decode_attention import group_chunk, split_count
from repro_torch.kernels.ref import decode_attention_ref, topk_select_ref

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


# ---------------------------------------------------------------------------
# the kernel's split-S design (csrc/decode_attention.cu), modelled in torch
# ---------------------------------------------------------------------------


def _split_model(q, k, v, lengths, n_split, tile):
    """The kernel's partition and combine in plain float32 torch: row b
    attends L_b rows (S where lengths[b] <= 0, else min(lengths[b], S));
    split j takes rows [j*c, min((j+1)*c, L_b)), c = ceil(L_b / n_split)
    rounded up to ``tile``; each split's partial is (m, l, acc), an empty
    split's (-inf, 0, 0); the partials combine in split order."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, h, d), dtype=torch.float32)
    for bi in range(b):
        n = int(lengths[bi])
        rows = s if n <= 0 else min(n, s)
        per = -(-rows // n_split)
        per = -(-per // tile) * tile
        qg = q[bi].float().reshape(kvh, h // kvh, d)
        parts = []
        for j in range(n_split):
            r0 = min(j * per, rows)
            r1 = min(r0 + per, rows)
            if r0 == r1:
                parts.append((torch.full(qg.shape[:2], -torch.inf),
                              torch.zeros(qg.shape[:2]), torch.zeros(qg.shape)))
                continue
            kk, vv = k[bi, r0:r1].float(), v[bi, r0:r1].float()
            sc = (torch.zeros(qg.shape[:2] + (r1 - r0,)) if n <= 0 else
                  torch.einsum("kgd,rkd->kgr", qg, kk) / (d ** 0.5))
            m = sc.max(-1).values
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgr,rkd->kgd", p, vv)))
        mx = torch.stack([m for m, _, _ in parts]).max(0).values
        total = torch.zeros_like(mx)
        acc = torch.zeros(qg.shape)
        for m, l, a in parts:
            w = torch.exp(m - mx)          # 0 for an empty split
            total = total + l * w
            acc = acc + a * w[..., None]
        out[bi] = (acc / total[..., None]).reshape(h, d)
    return out


@pytest.mark.parametrize("h,kvh", [(4, 4), (24, 8), (28, 4), (16, 1)])
@pytest.mark.parametrize("n_split", [1, 3, 8, 64])
def test_split_partition_and_ordered_combine_match_the_refs(h, kvh, n_split):
    """Groups 1, 3, 7 and 16; lengths 0, 1, S and S+1, 128 (on a split
    boundary at 8 splits: 4 splits of 32 rows), and 2 and 97, which leave
    more splits than valid rows (empty partials must weigh 0, not NaN)."""
    s, d = 300, 64
    lengths = np.array([0, 1, s, s + 1, 128, 2, 97], np.int32)
    b = lengths.shape[0]
    q, k, v = _inputs(b, h, kvh, d, s, seed=h * 7 + n_split)
    tile = 32       # csrc Cfg::kTile in float32 at D = 64: 16 KB of k and v
    got = _split_model(_torch(q), _torch(k), _torch(v), lengths, n_split, tile)
    assert torch.isfinite(got).all()
    mine = decode_attention_ref(_torch(q), _torch(k), _torch(v),
                                torch.from_numpy(lengths))
    want = jax_ref.decode_attention_ref(_jax(q), _jax(k), _jax(v),
                                        jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,kvh,groups,s,want", [
    (8, 8, 3, 8192, 8),       # the server's call: 512 blocks
    (4, 8, 3, 32768, 16),     # decode_32k's cache: 512 blocks
    (4, 4, 7, 1536, 24),      # float32, group 7: 384 blocks
    (1, 8, 3, 32768, 64),     # batch 1 over 32,768 rows: 512 blocks
    (2, 1, 1, 40, 1),         # a cache shorter than one split
])
def test_split_count_fills_the_card(b, kvh, groups, s, want):
    """About four blocks for each of an H100's 132 SMs, from the shapes
    alone (never the lengths), at most 64 splits."""
    got = split_count(b, kvh, groups, s, sms=132)
    assert got == want
    blocks = b * kvh * -(-groups // group_chunk(groups)) * got
    assert blocks <= 4 * 132


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    """No launch is counted and the result is the plain version's, bit for
    bit, for decode attention and top-k alike."""
    q, k, v = _inputs(3, 24, 8, 128, 50, seed=21)
    lengths = torch.tensor([0, 17, 51], dtype=torch.int32)
    keys = torch.from_numpy(np.random.default_rng(21).normal(size=433)
                            .astype(np.float32))
    build.reset_launch_counts()
    got = ops.decode_attention(_torch(q), _torch(k), _torch(v), lengths)
    top = ops.topk_select(keys, 10)
    assert build.launch_counts() == {name: 0 for name in build.KERNELS}
    assert torch.equal(got, decode_attention_ref(_torch(q), _torch(k),
                                                 _torch(v), lengths))
    assert torch.equal(top, topk_select_ref(keys, 10))
