"""Carry the reference's parameters into ``CausalLM``.

The JAX package keeps a model's parameters as a nested dict: ``embed``,
``final_norm``, ``head`` (untied only), ``prefix`` (a list of blocks) and
``stack`` (``sub0`` ... ``sub{period-1}``, each leaf stacked on a leading
``(n_periods,)`` axis).  ``params_from_numpy`` takes that tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and copies it into a
``CausalLM``, so that both packages compute the same function.
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


def _load_block(block, tree: Dict, name: str) -> None:
    expected = {"ln1", "attn", "ln2", "ffn"}
    if set(tree) != expected:
        raise ValueError(f"{name}: keys {sorted(tree)}, expected "
                         f"{sorted(expected)}")
    _copy(block.ln1, tree["ln1"], f"{name}/ln1")
    _copy(block.ln2, tree["ln2"], f"{name}/ln2")
    for part, module in (("attn", block.attn), ("ffn", block.ffn)):
        mine = dict(module.named_parameters(recurse=False))
        if set(tree[part]) != set(mine):
            raise ValueError(f"{name}/{part}: keys {sorted(tree[part])}, the "
                             f"model has {sorted(mine)}")
        for key, param in mine.items():
            _copy(param, tree[part][key], f"{name}/{part}/{key}")


@torch.no_grad()
def params_from_numpy(cfg: ArchConfig, tree: Dict, device=None,
                      dtype: Optional[torch.dtype] = None) -> CausalLM:
    """A ``CausalLM`` of ``cfg`` on ``device`` (the card unless "cpu") in
    compute ``dtype`` (the config's by default), holding the parameters of
    the reference's tree.  Matmul weights and norms are cast once to the
    compute dtype (the reference casts at every use: the same values); the
    embedding and an untied head stay float32."""
    model = CausalLM(cfg, device=device, dtype=dtype)
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_norm, tree["final_norm"], "final_norm")
    if model.head is not None:
        _copy(model.head, tree["head"], "head")
    elif "head" in tree:
        raise ValueError("tied embeddings, but the tree has a head")
    blocks = list(model.blocks)
    n_prefix = cfg.first_dense_layers
    for i, bt in enumerate(tree["prefix"]):
        _load_block(blocks[i], bt, f"prefix/{i}")
    period = _period_len(cfg)
    stack = tree["stack"]
    n_periods = (cfg.n_layers - n_prefix) // period
    for j in range(period):
        for i in range(n_periods):
            _load_block(blocks[n_prefix + i * period + j],
                        _period_slice(stack[f"sub{j}"], i),
                        f"stack/sub{j}/{i}")
    return model


def _period_slice(tree: Dict, i: int) -> Dict:
    """Entry ``i`` of every leaf of a stacked (n_periods, ...) subtree."""
    return {k: _period_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
