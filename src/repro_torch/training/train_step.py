"""The train step — counterpart of ``repro/training/train_step.py``
(``init_train_state``, ``make_train_step``).

The reference holds float32 parameters and casts each to the compute dtype
where it is used (its stacked leaves of three or more dimensions before the
scan), so its gradient of a float32 leaf is the float32 cast of the
gradient of the compute-dtype copy.  Here the train state holds float32
masters and AdamW moments, by parameter name; ``make_train_step`` keeps one
working ``CausalLM`` in the compute dtype, laid out as the serving model is
(matmul weights and norms in the compute dtype; the embedding, an untied
head, whisper's position tables, the MoE router and Mamba's ``a_log``
float32, the last two rounded in the forward's stack as the reference's
cast does).  Each step copies the masters into it, ``torch.autograd``
gives its gradients (each scan step of the reference recomputed in the
backward pass, ``CausalLM.forward``), and ``adamw_update`` upcasts them
leaf by leaf.

The reference's GSPMD sharding rules (``_spec_for``, ``param_shardings``,
``state_shardings``, ``batch_shardings``) are the port's shard layouts in
``launch/sharding.py``, beside the dry run that uses them.
"""
from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import torch

from ..configs.base import ArchConfig
from ..models.lm import CausalLM
from .optimizer import OptConfig, adamw_update, init_opt_state


def init_train_state(cfg: ArchConfig, device=None, seed: int = 0,
                     model: Optional[CausalLM] = None) -> Dict:
    """{"params": float32 masters by parameter name, "opt":
    ``init_opt_state``}.  The masters are ``model``'s parameters (a float32
    ``CausalLM``, e.g. ``params_from_numpy(..., dtype=torch.float32)``), or those
    of a float32 ``CausalLM`` drawn from ``seed`` on ``device`` (the card
    unless "cpu")."""
    if model is None:
        model = CausalLM(cfg, device=device, seed=seed, dtype=torch.float32)
    params = {name: p.detach() for name, p in model.named_parameters()}
    wrong = [name for name, p in params.items() if p.dtype != torch.float32]
    if wrong:
        raise ValueError(f"masters must be float32: {wrong[:3]}")
    return {"params": params, "opt": init_opt_state(params)}


def decayed(model: CausalLM) -> Set[str]:
    """The parameters the reference's AdamW decays: the leaves of two or
    more dimensions of its tree, where every leaf of a layer stack (the
    scanned blocks, whisper's encoder and cross-attention layers) carries a
    leading layer axis.  So a norm or a bias is decayed in the stack and
    not in a prefix block or as ``final_norm``."""
    stacked = tuple(f"blocks.{i}." for i in range(model.n_prefix,
                                                  len(model.blocks)))
    return {name for name, p in model.named_parameters()
            if p.dim() >= 2 or name.startswith(stacked + ("enc.", "cross."))}


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[OptConfig] = None,
                    device=None):
    """→ ``train_step(state, batch) → (state, {"loss", "grad_norm"})`` on
    ``device`` (the card unless "cpu"; the state's tensors must be there).
    ``batch`` holds ``tokens`` and ``targets`` (B,S) int64, and a VLM's
    ``img_embeds`` or an encoder-decoder's ``frames``.  The state is
    updated in place and returned; ``keep_grads=True`` adds the step's
    gradients (by name, in the compute dtype) to the metrics as
    ``"grads"``.  ``train_step.model`` is the working model."""
    opt_cfg = opt_cfg or OptConfig()
    model = CausalLM(cfg, device=device)
    for p in model.parameters():
        p.requires_grad_(True)
    decay = decayed(model)

    def train_step(state: Dict, batch: Dict,
                   keep_grads: bool = False) -> Tuple[Dict, Dict]:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state["params"][name])
        loss = model.loss_fn(batch)
        loss.backward()
        grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
                 for name, p in model.named_parameters()}
        _, opt, gnorm = adamw_update(state["params"], grads, state["opt"],
                                     opt_cfg, decay)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        if keep_grads:
            metrics["grads"] = grads
        del grads
        for p in model.parameters():
            p.grad = None
        return {"params": state["params"], "opt": opt}, metrics

    train_step.model = model
    return train_step
