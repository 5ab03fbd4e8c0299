"""The model cells of the dry run: one shard's program of each
(configuration x shape) cell on the production mesh — counterpart of
``repro/launch/dryrun.py``'s ``input_specs`` :51, ``_batch_spec`` :74,
``cache_shardings`` :84 and ``lower_cell`` :130.

The reference declares its inputs, hands GSPMD the layouts of
``training/train_step.py``'s rules and reads the compiled program.  The
port has no GSPMD: ``lower_cell`` builds the program of one shard (shard 0
of the 16 x 16 or 2 x 16 x 16 mesh) by hand, and ``analyze`` runs it once
under ``analysis.OpCounter`` on ``meta`` tensors (shapes only, nothing
allocated, no card; autograd runs there, where fake CUDA tensors of a build
without CUDA cannot take a backward).  The same program runs on real
tensors on the card (``device=``), where its peak can be measured.

**What a shard holds.**  Its parameters are the layouts' pieces
(``sharding.param_layouts``; argument bytes from ``sharding.local_shape``):
float32 masters and AdamW moments with FSDP over the data axes for
``train``, the compute dtype with tensor parallelism only for ``prefill``
and ``decode``, as ``dryrun.py:146–201``.  Its inputs are its batch rows
(``batch_spec``: none split where the batch does not divide the data
axes), and for ``decode`` its piece of the cache (``cache_layouts``: S over
``model``).  The model is the port's ``CausalLM`` on those pieces: each
parameter reads through a ``UseLayout`` that gathers what the shard's
program uses, so the modules run at the local widths — heads, ``d_ff``,
experts, the vocabulary and Mamba's din divided over ``model``, the batch
over the data axes.

**The schedule** (collectives through ``CountingMesh``'s ``shard_*`` forms,
counted by ``hlo_analysis.py``'s rules, per shard):

* FSDP (``train``): every weight is cast to the compute dtype and
  all-gathered over the data axes at each use (the recompute's too); its
  gradient is reduce-scattered back.  A weight not split over the data
  axes (the embedding, the head, norms, biases, positions) has its
  gradient all-reduced over them.
* Weights a shard uses whole or split another way are all-gathered over
  ``model`` at each use: the router, Mamba's ``wx`` (used split on din)
  and ``wdt`` (split on din's columns).
* Projections whose heads a shard needs whole are all-gathered over their
  columns (``layers.kv_columns``): k and v where the KV heads do not divide
  ``model`` (the reference's ``constrain`` replicates k/v there,
  ``layers.py:139–145``), MLA's latent ``x @ wdkv``.
* Sequence parallelism: from the stack's input (``lm._constrain_sp``,
  where S divides ``model``) the residual stream holds S / 16 rows; each
  mixer and ffn all-gathers it (``layers.tp_in``) and reduce-scatters its
  row-parallel partial sums (``layers.tp_out``); the backward mirrors
  both.  Without it (a prefix block, the encoder, decode) the partial sums
  are all-reduced and the input gradients too.
* Mamba's ``x @ wx`` on split din: an all-reduce of the partial
  projection (``layers.tp_sum``).
* The vocabulary: the embedding lookup sums the slices (an all-reduce of
  the rows); the loss all-reduces each row's max, its sum of exponentials
  and the target's log-probability; ``prefill`` all-reduces the last
  position from its owner.  The global-norm clip all-reduces one scalar,
  the loss its sum and count over the data axes.
* MoE: the shard routes its tokens (one dispatch group: the reference's
  ``_moe_groups`` makes each data shard a group) to all experts with the
  group's capacity, packs and runs its E / 16 experts only, and combines
  their partial output, which the block's ``tp_out`` sums with the rest.
  No all-to-all: the tokens are whole on every shard of ``model`` after
  the stream's all-gather.
* ``decode``: the cache splits S over ``model`` and keeps every KV head, so
  a shard gathers q over ``model`` (all heads), attends over its rows
  (``decode_attention``, counted by its formula over its rows), and
  all-reduces the partial softmaxes (output and its log-sum-exp); MLA
  gathers ``wuk``/``wuv`` to expand its latent rows for every head; whisper
  all-gathers ``enc_out``'s d once a step.

**Uneven widths**, as GSPMD pads them: a shard holds ceil(H / 16) query
heads (llama3.2-3b's 24: 2 a shard, 32 over the mesh), its ``wq``/``bq``
columns and ``wo`` rows padded to that; where the KV heads do not divide
the axis, a shard takes the KV heads its query heads read.  Each padded
width is listed in the record (``padded``).

**Loops.**  The cells' programs hold long loops of identical iterations
(q and kv blocks at 32k tokens, Mamba's time steps); ``sample=True`` runs
one iteration of each standing for all (``analysis.OpCounter.iteration``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize
from torch.utils._pytree import tree_leaves, tree_map

from ..configs.base import ArchConfig, Shape, get_config
from ..kernels.decode_attention import decode_attention
from ..models import layers as L
from ..models.lm import CausalLM
from ..training.optimizer import OptConfig, adamw_update
from ..training.train_step import decayed
from . import sharding as S
from .analysis import CountingMesh, OpCounter, nbytes
from .mesh import make_production_mesh
from .sql_dryrun import Spec

MODEL = S.MODEL


# ---------------------------------------------------------------------------
# specs (dryrun.py:51–121)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: Shape) -> Dict[str, Spec]:
    """Every model input's shape and dtype: tokens (and a train cell's
    targets), a VLM's ``img_embeds`` (B, tiles x patches, d) and an
    encoder-decoder's ``frames`` (B, enc_seq, d) outside decode."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": Spec((b, s), torch.int32),
                 "targets": Spec((b, s), torch.int32)}
    elif shape.kind == "prefill":
        batch = {"tokens": Spec((b, s), torch.int32)}
    else:           # decode: one new token against a seq_len cache
        batch = {"tokens": Spec((b, 1), torch.int32)}
    dt = getattr(torch, cfg.dtype)
    if cfg.n_img_tiles and shape.kind != "decode":
        batch["img_embeds"] = Spec((b, cfg.n_img_tiles * cfg.img_patches,
                                    cfg.d_model), dt)
    if cfg.enc_layers and shape.kind != "decode":
        batch["frames"] = Spec((b, cfg.enc_seq, cfg.d_model), dt)
    return batch


def batch_spec(mesh, b: int) -> S.Layout:
    """The batch dimension's layout: over the data axes where they divide
    ``b``, else replicated (``long_500k``'s batch of 1)."""
    axes = S.data_axes(mesh)
    return (axes,) if b % math.prod(S.sizes(mesh)[a] for a in axes) == 0 \
        else (None,)


_CACHE_TAILS = {          # leaf → its layout after the batch entry
    "k": [MODEL, None, None], "v": [MODEL, None, None],   # (B,S,KVH,hd)
    "ckv": [MODEL, None], "krope": [MODEL, None],         # (B,S,rank)
    "enc_out": [None, MODEL],                             # (B,1500,d)
    "conv": [None, MODEL],                                # (B,K-1,din)
    "ssm": [MODEL, None],                                 # (B,din,N)
}


def cache_layouts(cache: Dict, mesh, b: int) -> Dict:
    """The cache's layouts by leaf name: batch over the data axes (where
    they divide it), the cached sequence over ``model`` (MLA's latent rows
    too), whisper's ``enc_out`` and Mamba's state on din / d over
    ``model``, ``length`` by batch."""
    baxes = batch_spec(mesh, b)[0]

    def leaf(name, t):
        if name == "length":
            return (baxes,)
        if name in _CACHE_TAILS:
            return S.layout([baxes] + _CACHE_TAILS[name], t.dim())
        return S.layout([], t.dim())

    return {"layers": [{k: leaf(k, t) for k, t in layer.items()}
                       for layer in cache["layers"]],
            **{k: leaf(k, t) for k, t in cache.items() if k != "layers"}}


# ---------------------------------------------------------------------------
# collectives with their backward
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """All-gather forward, reduce-scatter of the gradient backward."""

    @staticmethod
    def forward(ctx, x, prog, axes, dim):
        ctx.prog, ctx.axes, ctx.dim = prog, axes, dim
        return prog.coll.shard_all_gather(x, axes, dim, prog.scale())

    @staticmethod
    def backward(ctx, g):
        p = ctx.prog
        return (p.coll.shard_reduce_scatter(g, ctx.axes, ctx.dim, p.scale()),
                None, None, None)


class _Scatter(torch.autograd.Function):
    """Reduce-scatter forward, all-gather of the gradient backward."""

    @staticmethod
    def forward(ctx, x, prog, axes, dim):
        ctx.prog, ctx.axes, ctx.dim = prog, axes, dim
        return prog.coll.shard_reduce_scatter(x, axes, dim, prog.scale())

    @staticmethod
    def backward(ctx, g):
        p = ctx.prog
        return (p.coll.shard_all_gather(g, ctx.axes, ctx.dim, p.scale()),
                None, None, None)


class _Sampled(list):
    """A sampled loop's outputs: those of the iterations run (``heads``, in
    the graph), then the last one's detached alias standing for each other
    one."""

    def __init__(self, heads: list, n: int):
        self.heads = heads
        super().__init__(heads + [_detached(heads[-1])] * (n - len(heads)))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _detached(tree):
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                    else t, tree)


# ---------------------------------------------------------------------------
# the shard program: the ambient mesh of one shard
# ---------------------------------------------------------------------------


class ShardProgram(L.MeshContext):
    """Shard 0's program on ``mesh``: the hooks of ``models/layers.py``
    and ``models/lm.py`` make the collectives of the module docstring's
    schedule on ``coll`` (a ``CountingMesh``)."""

    partitioned = True

    def __init__(self, cfg: ArchConfig, mesh, sample: bool = True):
        super().__init__(mesh.axes)
        self.cfg = cfg
        self.coll = CountingMesh(mesh.axes, mesh.device)
        self.m = self.sizes.get(MODEL, 1)
        self.data = S.data_axes(mesh)
        self.sample = sample
        self.counter: Optional[OpCounter] = None
        self.sp_full = self.sp_local = None
        self.dtype = getattr(torch, cfg.dtype)

    # -- counting ----------------------------------------------------------
    def scale(self) -> float:
        return self.counter._mult() if self.counter is not None else 1.0

    def n(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def gather(self, x, axes, dim):
        return x if self.n(axes) == 1 else _Gather.apply(x, self, axes, dim)

    def all_reduce(self, x, axes):
        if self.n(axes) == 1:
            return x
        return self.coll.shard_all_reduce(x, axes, self.scale())

    def grad_all_reduce(self, x, axes):
        """Identity; the gradient all-reduced over ``axes``."""
        if self.n(axes) == 1 or not (torch.is_grad_enabled()
                                     and x.requires_grad):
            return x
        y = x.view_as(x)
        y.register_hook(lambda g: self.coll.shard_all_reduce(
            g, axes, self.scale()))
        return y

    # -- the hooks ---------------------------------------------------------
    def moe_groups(self, t: int) -> int:
        return 1        # the shard's tokens are one dispatch group

    def expert_offset(self, e: int) -> int:
        return 0        # shard 0 holds the first E / 16 experts

    def sequence_parallel(self, x):
        if self.m == 1 or (self.sp_local is not None
                           and x.shape[1] == self.sp_local):
            return x
        self.sp_full, self.sp_local = x.shape[1], x.shape[1] // self.m
        return x.narrow(1, 0, self.sp_local).clone()

    def _sp(self, x, rows) -> bool:
        return (self.sp_local is not None and x.dim() == 3
                and x.shape[1] == rows)

    def tp_in(self, h):
        if self._sp(h, self.sp_local):
            return self.gather(h, (MODEL,), 1)
        return self.grad_all_reduce(h, (MODEL,))

    def tp_out(self, o):
        if self._sp(o, self.sp_full):
            return _Scatter.apply(o, self, (MODEL,), 1)
        return self.all_reduce(o, (MODEL,))

    def tp_sum(self, p):
        return self.all_reduce(p, (MODEL,))

    def kv_columns(self, t):
        cfg = self.cfg
        whole = t.shape[-1] == cfg.n_kv_heads * cfg.resolved_head_dim
        if whole or (cfg.mla is None and cfg.n_kv_heads % self.m == 0):
            return t
        return self.gather(t, (MODEL,), t.dim() - 1)

    def heads_kv(self, q, k, v):
        hl, kv = q.shape[2], k.shape[2]
        if hl % kv == 0:
            return k, v
        g = self.cfg.n_heads // self.cfg.n_kv_heads
        idx = [min(j, self.cfg.n_heads - 1) // g % kv for j in range(hl)]
        if hl % len(set(idx)) == 0:
            idx = sorted(set(idx))
        idx = torch.tensor(idx, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)

    def embed_rows(self, embed, tokens):
        if self.m == 1:
            return super().embed_rows(embed, tokens)
        vl = embed.shape[0]
        rows = embed[tokens.clamp(0, vl - 1)] * (tokens < vl)[..., None]
        return self.all_reduce(rows.to(self.dtype), (MODEL,))

    def vocab_log_softmax(self, logits):
        if self.m == 1:
            return super().vocab_log_softmax(logits)
        mx = self.all_reduce(logits.detach().amax(-1, keepdim=True), (MODEL,))
        z = logits - mx
        se = self.all_reduce(torch.exp(z).sum(-1, keepdim=True), (MODEL,))
        return z - torch.log(se)

    def vocab_take(self, logp, targets):
        if self.m == 1:
            return super().vocab_take(logp, targets)
        vl = logp.shape[-1]
        got = logp.gather(-1, targets.clamp(0, vl - 1)[..., None])[..., 0]
        return self.all_reduce(got * (targets < vl), (MODEL,))

    def last_position(self, hidden):
        if self._sp(hidden, self.sp_local):     # the last shard's row
            return self.all_reduce(hidden[:, -1:], (MODEL,))
        return super().last_position(hidden)

    def cache_enc_out(self, enc_out):
        return self.gather(enc_out, (MODEL,), 2)

    def _combine(self, o):
        """All-reduce the partial softmaxes of the S shards: each head's
        output and its log-sum-exp, in float32."""
        if self.m == 1:
            return o
        part = torch.cat([o.to(torch.float32),
                          o.new_zeros(o.shape[:-1] + (1,),
                                      dtype=torch.float32)], -1)
        return self.all_reduce(part, (MODEL,))[..., :-1].to(o.dtype)

    def _own_heads(self, o, hl):
        """(B, H, D) → this shard's first ``hl`` heads, zero-padded."""
        o = o[:, :hl]
        if o.shape[1] < hl:
            o = F.pad(o, (0, 0, 0, hl - o.shape[1]))
        return o

    def attention_decode(self, attn, q, k, v, cache_k, cache_v, length):
        b, hl, h = q.shape[0], q.shape[2], self.cfg.n_heads
        if k.shape[2] < cache_k.shape[2]:      # the cache keeps every head
            k = self.gather(k, (MODEL,), 2)
            v = self.gather(v, (MODEL,), 2)
        row = length.to(torch.int64).clamp(0, cache_k.shape[1] - 1)
        batch = torch.arange(b, device=q.device)
        cache_k[batch, row] = k[:, 0]
        cache_v[batch, row] = v[:, 0]
        qa = self.gather(q, (MODEL,), 2)[:, 0, :h].contiguous()
        o = self._combine(decode_attention(qa, cache_k, cache_v, length + 1))
        return self._own_heads(o, hl).reshape(b, 1, -1) @ attn.wo

    def mla_decode(self, mla, x, cache_ckv, cache_krope, length):
        m, h = self.cfg.mla, self.cfg.n_heads
        b = x.shape[0]
        pos = length[:, None].to(torch.int32)
        c_kv, k_rope = mla._latent(x, pos)
        row = length.to(torch.int64).clamp(0, cache_ckv.shape[1] - 1)
        batch = torch.arange(b, device=x.device)
        cache_ckv[batch, row] = c_kv[:, 0]
        cache_krope[batch, row] = k_rope[:, 0]
        q = mla._q(x, pos)
        hl = q.shape[2]
        q = self.gather(q, (MODEL,), 2)[:, 0, :h].to(torch.float32)
        wuk = self.gather(mla.wuk, (MODEL,), 1)[:, :h * m.qk_nope_head_dim]
        wuv = self.gather(mla.wuv, (MODEL,), 1)[:, :h * m.v_head_dim]
        o = self._combine(mla.attend_latent(q, cache_ckv, cache_krope,
                                            length, wuk, wuv, x.dtype))
        return self._own_heads(o, hl).reshape(b, 1, -1) @ mla.wo

    # -- loops: one iteration standing for n -------------------------------
    def _sampling(self, n: int) -> bool:
        return self.sample and self.counter is not None and n > 1

    def loop_map(self, n, body):
        if not self._sampling(n):
            return super().loop_map(n, body)
        with self.counter.iteration(n):
            out = body(0)
        return _Sampled([out], n)

    # a fold or a scan runs its first iteration as it is (its carry in is
    # the loop's), then its second standing for the n - 1 after it (a carry
    # in made by an iteration, as theirs is)
    def loop_fold(self, n, body, carry):
        if not self._sampling(n) or n <= 2:
            return super().loop_fold(n, body, carry)
        box = [body(0, carry)]
        with self.counter.iteration(n - 1, carry=lambda: _tensors(box[-1])):
            box.append(body(1, box[0]))
        return box[-1]

    def loop_scan(self, n, body, carry):
        if not self._sampling(n) or n <= 2:
            return super().loop_scan(n, body, carry)
        box = [body(0, carry)]
        with self.counter.iteration(n - 1,
                                    carry=lambda: _tensors(box[-1][0])):
            box.append(body(1, box[0][0]))
        return box[-1][0], _Sampled([box[0][1], box[1][1]], n)

    def stack_steps(self, ys, dim):
        if not isinstance(ys, _Sampled):
            return super().stack_steps(ys, dim)
        # the same bytes as stacking n outputs, without n inputs to check
        rest = ys[-1].unsqueeze(dim)
        rest = rest.expand(*rest.shape[:dim], len(ys) - len(ys.heads),
                           *rest.shape[dim + 1:])
        return torch.cat([h.unsqueeze(dim) for h in ys.heads] + [rest], dim)


# ---------------------------------------------------------------------------
# parameters: the layouts' pieces, read through what the program uses
# ---------------------------------------------------------------------------


_COLUMNS = ("wq", "wk", "wv", "wdkv", "wuk", "wuv", "wg", "wu", "w1", "win",
            "conv", "head", "wdt")
_ROWS = ("wo", "wd", "w2", "wout", "bq", "bk", "bv", "dt_bias", "d_skip",
         "a_log", "embed", "wx")


def _use_model_dim(name: str, ndim: int, cfg: ArchConfig,
                   m: int) -> Optional[int]:
    """The dimension a shard's program uses split over ``model`` (None:
    whole)."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf in ("wg", "wu", "wd") and "ffn" in parts and ndim == 3:
        return 0                                  # experts
    if leaf in _COLUMNS:
        return ndim - 1
    if leaf in _ROWS:
        return 0
    return None                        # the router, norms, positions


def _head_width(model: CausalLM, name: str) -> Optional[int]:
    """The width of one query head in a head-split leaf's split dimension
    (``wq``/``bq`` columns, ``wo`` rows; MLA's ``wuk``/``wuv`` too)."""
    cfg, parts = model.cfg, name.split(".")
    leaf = parts[-1]
    mla = (cfg.mla is not None and parts[0] == "blocks"
           and model.plan[int(parts[1])].mixer == "mla")
    if "attn" not in parts:
        return None
    if mla:
        m = cfg.mla
        return {"wq": m.qk_nope_head_dim + m.qk_rope_head_dim,
                "wuk": m.qk_nope_head_dim, "wuv": m.v_head_dim,
                "wo": m.v_head_dim}.get(leaf)
    return cfg.resolved_head_dim if leaf in ("wq", "bq", "wo") else None


class UseLayout(nn.Module):
    """What a shard's program reads of a parameter's piece: cast to the
    module's dtype; gathered over the axes the program does not split it
    on (FSDP's data axes, and ``model`` where the program uses it whole or
    split on another dimension); the program's own piece taken where it
    splits a gathered dimension; head-split widths padded to whole heads.
    A training step all-reduces the gradient of a piece the data axes do
    not split."""

    def __init__(self, prog: ShardProgram, dtype, gathers, grad_axes,
                 slices, pads):
        super().__init__()
        self.prog, self.dtype = prog, dtype
        self.gathers, self.grad_axes = gathers, grad_axes
        self.slices, self.pads = slices, pads

    def forward(self, w):
        t = w.to(self.dtype)
        if self.grad_axes:
            t = self.prog.grad_all_reduce(t, self.grad_axes)
        for dim, axes in self.gathers:
            t = self.prog.gather(t, axes, dim)
        for dim, size in self.slices:
            t = t.narrow(dim, 0, size)
        for dim, size in self.pads:
            pad = [0, 0] * (t.dim() - dim - 1) + [0, size - t.shape[dim]]
            t = F.pad(t, pad)
        return t


def _module(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf


@dataclasses.dataclass
class ModelCell:
    """One cell's shard program, ready to run: ``run(counter)`` runs it
    once (counted where ``counter`` is an ``OpCounter``) and returns its
    outputs."""

    cfg: ArchConfig
    shape: Shape
    mesh: object
    prog: ShardProgram
    arg_bytes: int
    arg_detail: Dict[str, int]
    padded: List[str]
    args: List[torch.Tensor]
    body: Callable

    def run(self, counter: Optional[OpCounter] = None):
        self.prog.counter = counter
        self.prog.sp_full = self.prog.sp_local = None
        with L.mesh_context(self.prog):
            return self.body()


_ONES = ("ln1", "ln2", "ln", "final_norm", "q_norm", "k_norm", "kv_norm",
         "d_skip")


# a real run's float draws: the all-gathers tile one shard's piece, so a
# gathered weight sums up to 16 equal blocks coherently; at N(0, 0.02)
# llama3.2-3b's 28 layers overflow the bf16 gradients
REAL_SCALE = 2e-3


def _leaf_arg(shape, dtype, device, gen, ones: bool = False):
    """An argument's piece: shapes only on ``meta``; else float draws of
    N(0, ``REAL_SCALE``) (ones for a norm's weights, as the model's),
    integer zeros."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if ones:
        return torch.ones(shape, dtype=dtype, device=device)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen, device=device)
                * REAL_SCALE).to(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def _shard_params(model: CausalLM, prog: ShardProgram, mesh, train: bool,
                  gen, padded: List[str]) -> Tuple[Dict, int]:
    """Replace each parameter of ``model`` (full size, on ``meta``) by its
    piece (a new leaf on the mesh's device) read through ``UseLayout`` →
    (name → piece, argument bytes of the pieces)."""
    cfg, m = model.cfg, prog.m
    n_exp = cfg.moe.n_experts if cfg.moe else None
    lays = S.param_layouts(model, mesh, fsdp=train, n_experts=n_exp)
    store = torch.float32 if train else getattr(torch, cfg.dtype)
    heads = -(-cfg.n_heads // m)
    pieces, total = {}, 0
    for name, p in list(model.named_parameters()):
        lay = lays[name]
        local, pad = S.local_shape(p.shape, lay, mesh)
        padded += [f"{name} dim {d}: {size} over {n}" for d, size, n in pad]
        w = nn.Parameter(_leaf_arg(local, store, prog.coll.device, gen,
                                   name.split(".")[-1] in _ONES),
                         requires_grad=train)
        total += nbytes(w)
        use_dim = _use_model_dim(name, p.dim(), cfg, m)
        gathers, slices, pads = [], [], []
        for dim, entry in enumerate(lay):
            axes = tuple(a for a in (entry or ()) if not (
                a == MODEL and dim == use_dim))
            if axes:
                gathers.append((dim, axes))
        if use_dim is not None and MODEL not in (lay[use_dim] or ()) \
                and m > 1:
            slices.append((use_dim, -(-p.shape[use_dim] // m)))
        width = _head_width(model, name)
        if width and use_dim is not None and cfg.n_heads % m:
            pads.append((use_dim, heads * width))
        grad_axes = ()
        if train:
            split = {a for e in lay for a in (e or ())}
            grad_axes = tuple(a for a in prog.data if a not in split)
        mod, leaf = _module(model, name)
        mod._parameters[leaf] = w
        parametrize.register_parametrization(
            mod, leaf, UseLayout(prog, p.dtype if train else store, gathers,
                                 grad_axes, slices, pads), unsafe=True)
        pieces[name] = w
    attention = any(k.mixer != "mamba" for k in model.plan)
    if cfg.n_heads % m and attention:
        padded.append(f"n_heads: {cfg.n_heads} over model {m}: {heads} a "
                      f"shard ({heads * m})")
    if cfg.n_kv_heads % m and cfg.mla is None and attention:
        padded.append(f"n_kv_heads: {cfg.n_kv_heads} over model {m}: k and "
                      f"v gathered whole")
    return pieces, total


def _local_inputs(specs: Dict[str, Spec], lays: Dict, mesh, device, gen,
                  vocab: int) -> Tuple[Dict, int]:
    """One shard's pieces of the inputs; a real run draws its tokens below
    ``vocab``."""
    out, total = {}, 0
    for k, spec in specs.items():
        local, _ = S.local_shape(spec.shape, lays[k], mesh)
        if device.type == "meta" or spec.dtype.is_floating_point:
            t = _leaf_arg(local, spec.dtype, device, gen)
        else:
            t = torch.randint(0, vocab, local, generator=gen, device=device,
                              dtype=spec.dtype)
        out[k] = t
        total += nbytes(t)
    return out, total


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               cfg: Optional[ArchConfig] = None, shape: Optional[Shape] = None,
               mesh=None, device="meta", sample: bool = True,
               seed: int = 0) -> Tuple[ArchConfig, Shape, ModelCell]:
    """Shard 0's program of the cell (``arch`` x ``shape_name`` on the
    16 x 16 mesh, or 2 x 16 x 16 with ``multi_pod``) → (cfg, shape, the
    cell).  ``cfg``, ``shape`` and ``mesh`` (a ``ShardMesh`` with ``data``
    and ``model`` axes, and ``pod``) replace the cell's own; ``device``
    holds its tensors (``meta``: shapes only; the card: random pieces drawn
    from ``seed``); ``sample``: one iteration of a long loop stands for
    all (counted runs only)."""
    cfg = cfg or get_config(arch)
    shape = shape or next(s for s in cfg.shapes() if s.name == shape_name)
    device = torch.device(device)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    train = shape.kind == "train"
    prog = ShardProgram(cfg, mesh, sample)
    model = CausalLM(cfg, device="meta")
    decay = decayed(model) if train else set()
    padded: List[str] = []
    params, p_bytes = _shard_params(model, prog, mesh, train, gen, padded)
    specs = input_specs(cfg, shape)
    b = shape.global_batch
    detail = {"params": p_bytes}
    if shape.kind == "decode":
        lays = {"tokens": batch_spec(mesh, b) + (None,)}
    else:
        lays = S.batch_layouts(specs, mesh)
    # a real run's tokens fall in shard 0's slice of the vocabulary: the
    # shard's program sums no other slice, so a token outside it would read
    # a zero embedding row (and the norms' eps would scale its gradients)
    batch, detail["batch"] = _local_inputs(
        specs, lays, mesh, device, gen, min(cfg.vocab,
                                            cfg.padded_vocab // prog.m))
    args = list(params.values()) + list(batch.values())

    if train:
        opt = {"mu": {k: torch.zeros_like(p, requires_grad=False)
                      for k, p in params.items()},
               "nu": {k: torch.zeros_like(p, requires_grad=False)
                      for k, p in params.items()},
               "step": torch.zeros((), dtype=torch.int32, device=device)}
        detail["opt"] = sum(nbytes(t) for t in tree_leaves(opt))
        args += tree_leaves(opt)

        def body():
            loss = model.loss_fn(batch)
            # the loss's sum and count over the data shards
            prog.all_reduce(torch.zeros(2, device=device), prog.data)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
            # the clip's global norm: one scalar over every shard
            prog.all_reduce(torch.zeros((), device=device),
                            tuple(prog.sizes))
            _, _, gnorm = adamw_update(params, grads, opt, OptConfig(), decay)
            for p in params.values():
                p.grad = None
            return loss.detach(), gnorm
    elif shape.kind == "prefill":
        def body():
            with torch.no_grad():
                return model.prefill(batch["tokens"], batch.get("img_embeds"),
                                     batch.get("frames"))
    else:
        full = model.init_cache(b, shape.seq_len)
        clays = cache_layouts(full, mesh, b)

        def piece(t, lay):
            local, _ = S.local_shape(t.shape, lay, mesh)
            return _leaf_arg(local, t.dtype, device, gen) \
                if t.dtype.is_floating_point or device.type == "meta" \
                else torch.zeros(local, dtype=t.dtype, device=device)

        cache = {"layers": [{k: piece(t, clays["layers"][i][k])
                             for k, t in layer.items()}
                            for i, layer in enumerate(full["layers"])],
                 **{k: piece(t, clays[k]) for k, t in full.items()
                    if k != "layers"}}
        detail["cache"] = sum(nbytes(t) for t in tree_leaves(cache))
        args += tree_leaves(cache)

        def body():
            with torch.no_grad():
                logits, _ = model.decode_step(cache, batch["tokens"])
            return logits
    cell = ModelCell(cfg, shape, mesh, prog, sum(detail.values()), detail,
                     padded, args, body)
    return cfg, shape, cell


def analyze(cell: ModelCell) -> dict:
    """Run the cell's shard program once under ``OpCounter`` → the
    reference's record keys, per shard (one shard's program: no division
    by the mesh)."""
    from .analysis import loop_corrected_flops
    from .dryrun import card_memory
    counter = OpCounter()
    t0 = time.perf_counter()
    with counter:
        out = cell.run(counter)
    run_s = time.perf_counter() - t0
    arg_keys = {t.untyped_storage()._cdata for t in cell.args}
    out_bytes = sum(nbytes(t) for t in _tensors(out)
                    if t.untyped_storage()._cdata not in arg_keys)
    del out
    resident = cell.arg_bytes + counter.peak
    mem = {"argument_bytes": cell.arg_bytes, "argument_detail": cell.arg_detail,
           "output_bytes": out_bytes,
           "temp_bytes": resident - cell.arg_bytes - out_bytes,
           "resident_bytes_per_chip": resident}
    budget = card_memory()
    mem.update(budget, fits_card=bool(resident <= budget["card_bytes"]))
    flops = loop_corrected_flops(counter)
    return {"flops_per_device": flops["flops"], "flops_detail": flops,
            "bytes_accessed_per_device": counter.bytes_accessed,
            "element_ops_per_device": counter.element_ops,
            "aten_ops": counter.ops,
            "bytes_by_op_per_device": dict(sorted(
                ((op, b) for op, (_, b) in counter.by_op.items()),
                key=lambda kv: -kv[1])[:12]),
            "collective_bytes_per_device": cell.prog.coll.collective_bytes(),
            "memory": mem, "n_chips": cell.mesh.size, "padded": cell.padded,
            "sampled_loops": cell.prog.sample, "run_time_s": round(run_s, 2)}


COUNT_KEYS = ("flops_detail", "bytes_accessed_per_device",
              "element_ops_per_device", "collective_bytes_per_device")
MEMORY_COUNTS = ("argument_bytes", "output_bytes", "temp_bytes",
                 "resident_bytes_per_chip")


def counts(record: dict) -> dict:
    """The counts of a model cell's record: what a run of the same program
    must reproduce (on another host, or on the card's build)."""
    out = {k: record[k] for k in COUNT_KEYS}
    out["memory"] = {k: record["memory"][k] for k in MEMORY_COUNTS}
    return out


# counts a PyTorch release's own backward formulas move: 2.11 allocates the
# zeros of some backwards through ``zeros`` where 2.13 uses ``new_zeros``,
# 16,777,216 fewer of phi3.5-moe train_4k's 8.06e12 bytes accessed a shard
# (2.1e-6)
RELEASE_DEPENDENT = ("bytes_accessed_per_device", "element_ops_per_device",
                     "temp_bytes", "resident_bytes_per_chip")
RELEASE_RTOL = 1e-5


def counts_differ(got: dict, want: dict, same_release: bool) -> dict:
    """The counts of ``got`` that differ from ``want``'s → {key: (got,
    want)}: every count exactly where both come from one PyTorch release,
    else the release-dependent ones within ``RELEASE_RTOL``."""
    flat = {**{k: v for k, v in got.items() if k != "memory"},
            **got["memory"]}
    ref = {**{k: v for k, v in want.items() if k != "memory"},
           **want["memory"]}
    out = {}
    for k, v in ref.items():
        if same_release or k not in RELEASE_DEPENDENT:
            if flat[k] != v:
                out[k] = (flat[k], v)
        elif abs(flat[k] - v) > RELEASE_RTOL * abs(v):
            out[k] = (flat[k], v)
    return out
