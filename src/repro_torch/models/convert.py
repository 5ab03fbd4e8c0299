"""Carry the reference's parameters into ``CausalLM``.

The JAX package keeps a model's parameters as a nested dict: ``embed``,
``final_norm``, ``head`` (untied only), ``prefix`` (a list of blocks) and
``stack`` (``sub0`` ... ``sub{period-1}``, each leaf stacked on a leading
``(n_periods,)`` axis: one block per period for uniform configurations,
jamba's 8).  A block holds ``ln1``, its mixer (``attn`` for GQA and MLA,
``mamba``) and, unless its ffn is ``none``, ``ln2`` and ``ffn`` (an MLP, or
an MoE with an MLP ``shared``).  An encoder-decoder adds ``enc_pos``,
``enc`` (encoder layers stacked on a leading ``(enc_layers,)`` axis),
``dec_pos`` and ``cross`` (one cross-attention per decoder layer, stacked
on ``(n_layers,)``).  ``params_from_numpy`` takes that tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and copies it into a
``CausalLM``, so that both packages compute the same function; every key
set must be the model's exactly.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from .lm import CausalLM, _period_len


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)}, the model's is "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.tensor(np.asarray(src)))


def _load_module(module: torch.nn.Module, tree: Dict, name: str) -> None:
    """Copy ``tree`` into ``module``: its keys must be the module's own
    parameters and child modules, each child a subtree."""
    params = dict(module.named_parameters(recurse=False))
    children = dict(module.named_children())
    if set(tree) != set(params) | set(children):
        raise ValueError(f"{name}: keys {sorted(tree)}, the model has "
                         f"{sorted(set(params) | set(children))}")
    for key, param in params.items():
        _copy(param, tree[key], f"{name}/{key}")
    for key, child in children.items():
        _load_module(child, tree[key], f"{name}/{key}")


@torch.no_grad()
def params_from_numpy(cfg: ArchConfig, tree: Dict, device=None,
                      dtype: Optional[torch.dtype] = None) -> CausalLM:
    """A ``CausalLM`` of ``cfg`` on ``device`` (the card unless "cpu") in
    compute ``dtype`` (the config's by default), holding the parameters of
    the reference's tree.  Matmul weights and norms are cast once to the
    compute dtype (the reference casts at every use: the same values); the
    embedding, an untied head, whisper's position tables, the MoE router
    and Mamba's ``a_log`` stay float32.  ``dtype=torch.float32`` gives a
    training run's float32 masters, every leaf as the tree holds it,
    whatever the config's compute dtype
    (``training.train_step.init_train_state(model=...)`` takes them)."""
    model = CausalLM(cfg, device=device, dtype=dtype)
    top = {"embed", "final_norm", "prefix", "stack"}
    if model.head is not None:
        top.add("head")
    if cfg.enc_layers:
        top |= {"enc_pos", "enc", "dec_pos", "cross"}
    if set(tree) != top:
        raise ValueError(f"tree: keys {sorted(tree)}, the model has "
                         f"{sorted(top)}")
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_norm, tree["final_norm"], "final_norm")
    if model.head is not None:
        _copy(model.head, tree["head"], "head")
    blocks = list(model.blocks)
    n_prefix = cfg.first_dense_layers
    if len(tree["prefix"]) != n_prefix:
        raise ValueError(f"prefix: {len(tree['prefix'])} blocks, the model "
                         f"has {n_prefix}")
    for i, bt in enumerate(tree["prefix"]):
        _load_module(blocks[i], bt, f"prefix/{i}")
    period = _period_len(cfg)
    stack = tree["stack"]
    subs = {f"sub{j}" for j in range(period)}
    if set(stack) != subs:
        raise ValueError(f"stack: keys {sorted(stack)}, expected {sorted(subs)}")
    n_periods = (cfg.n_layers - n_prefix) // period
    for j in range(period):
        for i in range(n_periods):
            _load_module(blocks[n_prefix + i * period + j],
                         _period_slice(stack[f"sub{j}"], i),
                         f"stack/sub{j}/{i}")
    if cfg.enc_layers:
        _copy(model.enc_pos, tree["enc_pos"], "enc_pos")
        _copy(model.dec_pos, tree["dec_pos"], "dec_pos")
        for name, layers, n in (("enc", model.enc, cfg.enc_layers),
                                ("cross", model.cross, cfg.n_layers)):
            if _leading(tree[name]) != {n}:
                raise ValueError(f"{name}: {sorted(_leading(tree[name]))} "
                                 f"stacked layers, the model has {n}")
            for i in range(n):
                _load_module(layers[i], _period_slice(tree[name], i),
                             f"{name}/{i}")
    return model


def _period_slice(tree: Dict, i: int) -> Dict:
    """Entry ``i`` of every leaf of a stacked (n_periods, ...) subtree."""
    return {k: _period_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _leading(tree: Dict) -> set:
    """The leading (stacked) sizes of a subtree's leaves."""
    return set().union(*(_leading(v) if isinstance(v, dict)
                         else {len(v)} for v in tree.values()))
