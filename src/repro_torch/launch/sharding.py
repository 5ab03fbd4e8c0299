"""Shard layouts and the production sharding rules — counterpart of
``repro/training/train_step.py``'s GSPMD rules (``_spec_for`` :51,
``_walk`` :84, ``param_shardings`` :95, ``state_shardings`` :135,
``batch_shardings`` :144).

A ``Layout`` is the port's ``PartitionSpec``: one entry per dimension,
``None`` (replicated) or a tuple of mesh axis names the dimension is split
over, in order.  ``local_shape`` gives one shard's piece, rounded up as
GSPMD pads an uneven split, with the padded dimensions listed;
``shard_bytes`` its bytes.

The rules are the reference's, applied to the reference's parameter tree.
The port's ``CausalLM`` holds one module per layer (``blocks.3.attn.wk``)
where the reference stacks the layers of its scan on a leading axis
(``stack/sub<j>``, ``enc``, ``cross``; ``models/convert.py`` gives the
mapping), so ``param_layouts`` maps each port name to the reference's leaf
path and stacked shape (``reference_leaf``), applies the rule there, and
gives the port's per-layer leaf the rule's tail, without the stacked axis.
The expert-parallel rule matches an ``(…, E, d, ff)`` leaf under ``ffn``
on ``shape[-3] == n_experts`` of the reference's (stacked) shape, as the
reference does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Layout = Tuple[Optional[Tuple[str, ...]], ...]

DATA = "data"
MODEL = "model"


def sizes(mesh) -> Dict[str, int]:
    """Axis name → size of a ``ShardMesh`` (or anything with ``axes``)."""
    return dict(mesh.axes)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(n for n in ("pod", DATA) if n in sizes(mesh))


def layout(spec: Sequence, ndim: int) -> Layout:
    """A reference-style spec (entries None, an axis name or a tuple of
    names; trailing entries may be left out) → a ``Layout`` of ``ndim``
    entries."""
    out = []
    for entry in list(spec) + [None] * (ndim - len(spec)):
        if entry is None:
            out.append(None)
        elif isinstance(entry, str):
            out.append((entry,))
        else:
            out.append(tuple(entry) or None)
    return tuple(out)


def split(entry, mesh) -> int:
    """Shards a dimension is split into by its layout entry."""
    s = sizes(mesh)
    return math.prod(s[a] for a in entry) if entry else 1


def local_shape(shape: Sequence[int], lay: Layout,
                mesh) -> Tuple[Tuple[int, ...], List[Tuple[int, int, int]]]:
    """One shard's shape: each dimension divided by its shard count, rounded
    up (GSPMD pads an uneven shard) → (shape, [(dim, size, shards) of each
    padded dimension])."""
    out, padded = [], []
    for dim, (size, entry) in enumerate(zip(shape, lay)):
        n = split(entry, mesh)
        out.append(-(-size // n))
        if size % n:
            padded.append((dim, size, n))
    return tuple(out), padded


def shard_bytes(shape: Sequence[int], dtype: torch.dtype, lay: Layout,
                mesh) -> int:
    local, _ = local_shape(shape, lay, mesh)
    return math.prod(local) * torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# the reference's rules (train_step.py:47–153), on its leaf paths
# ---------------------------------------------------------------------------


def fsdp_axes(mesh, fsdp: bool):
    """The FSDP axes entry: ('pod', 'data') on the multi-pod mesh, 'data'
    on one pod, None without FSDP (serving)."""
    if not fsdp:
        return None
    axes = data_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def spec_for(path: str, ndim: int, fsdp) -> Layout:
    """``_spec_for``: name-based rules; leading (stacked) dimensions
    replicated.  ``fsdp`` is ``fsdp_axes``'s entry (None: TP only)."""
    d = fsdp if fsdp else None
    leaf = path.split("/")[-1]

    def pad(tail):
        return layout([None] * (ndim - len(tail)) + list(tail), ndim)

    if leaf == "embed":
        return layout([MODEL, None], ndim)            # vocab-sharded
    if leaf == "head":
        return layout([None, MODEL], ndim) if ndim == 2 else pad([None, MODEL])
    if leaf in ("wq", "wk", "wv", "wg", "wu", "win", "wx", "router",
                "wdkv", "wuk", "wuv", "w1"):
        return pad([d, MODEL])                        # column-parallel
    if leaf in ("wo", "wd", "wout", "wdt", "w2"):
        return pad([MODEL, d])                        # row-parallel
    if leaf in ("bq", "bk", "bv", "dt_bias", "d_skip"):
        return pad([MODEL])
    if leaf == "conv":
        return pad([None, MODEL])
    if leaf == "a_log":
        return pad([MODEL, None])
    return layout([], ndim)          # norms, positions, scalars: replicated


def leaf_layout(path: str, shape: Sequence[int], fsdp,
                n_experts: Optional[int]) -> Layout:
    """``param_shardings``'s ``leaf_spec``: the expert-parallel rule for an
    ``(…, E, d, ff)`` leaf under ``ffn`` (experts on 'model', rows over the
    FSDP axes), else ``spec_for``."""
    parts = path.split("/")
    nd = len(shape)
    if (parts[-1] in ("wg", "wu", "wd") and nd >= 3 and "ffn" in parts
            and n_experts is not None and shape[-3] == n_experts):
        return layout([None] * (nd - 3) + [MODEL, fsdp, None], nd)
    return spec_for(path, nd, fsdp)


def reference_leaf(model, name: str,
                   shape: Sequence[int]) -> Tuple[str, Tuple[int, ...], bool]:
    """The reference's tree path of the port's parameter ``name`` (of
    ``shape``), its shape there, and whether it is stacked (a leading layer
    axis the port's leaf does not have)."""
    cfg = model.cfg
    parts = name.split(".")
    rest = "/".join(parts[2:])
    shape = tuple(shape)
    if parts[0] == "blocks":
        i = int(parts[1])
        if i < model.n_prefix:
            return f"/prefix/{i}/{rest}", shape, False
        j = (i - model.n_prefix) % model.period
        n_periods = (cfg.n_layers - model.n_prefix) // model.period
        return f"/stack/sub{j}/{rest}", (n_periods,) + shape, True
    if parts[0] == "enc":
        return f"/enc/{rest}", (cfg.enc_layers,) + shape, True
    if parts[0] == "cross":
        return f"/cross/{rest}", (cfg.n_layers,) + shape, True
    return "/" + name, shape, False


def param_layouts(model, mesh, fsdp: bool = True,
                  n_experts: Optional[int] = None,
                  shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                  ) -> Dict[str, Layout]:
    """Each parameter of ``model`` (a ``CausalLM``, e.g. on ``meta``) →
    its layout (also the AdamW moments').  ``shapes`` overrides the
    parameters' shapes (name → shape)."""
    axes = fsdp_axes(mesh, fsdp)
    out = {}
    for name, p in model.named_parameters():
        shape = shapes[name] if shapes else tuple(p.shape)
        path, ref_shape, stacked = reference_leaf(model, name, shape)
        lay = leaf_layout(path, ref_shape, axes, n_experts)
        if stacked:
            assert lay[0] is None, (name, lay)
            lay = lay[1:]
        out[name] = lay
    return out


def state_layouts(params: Dict[str, Layout]) -> Dict:
    """``state_shardings``: the masters and both moments laid out as the
    parameters, the step replicated."""
    return {"params": params, "opt": {"mu": params, "nu": params,
                                      "step": ()}}


def batch_layouts(specs: Dict, mesh) -> Dict[str, Layout]:
    """``batch_shardings``: every input's leading (batch) dimension over
    the data axes ('pod' and 'data' on two pods)."""
    axes = data_axes(mesh)
    return {k: layout([axes], len(s.shape)) for k, s in specs.items()}
