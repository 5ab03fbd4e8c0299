"""AdamW, the learning-rate schedule and int8 gradient compression —
counterpart of ``repro/training/optimizer.py``.

Functions on tensors and on dicts of tensors (a parameter dict maps names
to tensors, as ``CausalLM.named_parameters`` names them; the reference's
pytrees), not ``torch.optim``: the reference's schedule (linear warmup,
then a cosine to 10% of the peak) and decay rule (decoupled, on leaves of
two or more dimensions only) are the contract.

- ``adamw_update`` updates the parameters and the moments in place, one
  leaf at a time (the reference returns new trees): a step at full width
  holds no second copy of the masters or the moments.  Its arithmetic is
  the reference's in float32: the moments exactly, the bias-corrected step
  in float32 where the reference with JAX's x64 mode on promotes it to
  float64 (a new parameter then differs by at most an ulp).
- ``psum_compressed`` sums int8 payloads in int32 over an axis of a
  ``ShardMesh`` (``exchange/service.py``: a sharded tensor is
  ``(n_shards, ...)``, the collective a reduction over that axis), with the
  reference's mean-scale approximation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Set, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def init_opt_state(params: Tree) -> Dict:
    """{"mu", "nu": float32 zeros shaped as each parameter, "step": int32
    0 on the parameters' device}."""
    device = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup over
    ``warmup_steps``, then a cosine from 1 to 0.1 of ``lr`` at
    ``total_steps``; float32, as the reference's."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = None
    for g in tree.values():
        sq = (g.to(torch.float32) ** 2).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


# elements of a leaf updated at once: bounds the float32 temporaries of one
# leaf's update (the embedding of a 128k vocabulary is 0.4 G elements)
_CHUNK = 1 << 26


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Dict, cfg: OptConfig,
                 decay: Optional[Set[str]] = None
                 ) -> Tuple[Tree, Dict, torch.Tensor]:
    """One AdamW step: the gradients clipped to a global norm of
    ``clip_norm``, the moments, the bias-corrected step, decoupled weight
    decay on the leaves named in ``decay`` (by default those of two or
    more dimensions, the reference's rule; a model's layer stack passes
    its own set, ``train_step.decayed``).  ``params`` (any float dtype: a
    new value is rounded to it) and ``state`` are updated in place and
    returned with the global norm of the unclipped gradients."""
    if decay is None:
        decay = {name for name, p in params.items() if p.dim() >= 2}
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    c1 = (1 - b1 ** step.to(torch.float64)).to(torch.float32)
    c2 = (1 - b2 ** step.to(torch.float64)).to(torch.float32)
    for name, p in params.items():
        flat = [t.view(-1) for t in (p, grads[name], state["mu"][name],
                                     state["nu"][name])]
        for lo in range(0, flat[0].numel(), _CHUNK):
            pc, gc, mu, nu = (t[lo:lo + _CHUNK] for t in flat)
            g = gc.to(torch.float32) * scale
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * g * g)
            delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            p32 = pc.to(torch.float32)
            if name in decay:       # decoupled weight decay
                delta = delta + cfg.weight_decay * p32
            pc.copy_(p32 - lr * delta)
    state["step"] = step
    return params, state, gnorm


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback (data-parallel all-reduce)
# ---------------------------------------------------------------------------


# XLA compiles the reference's ``absmax / 127.0`` as a product with the
# float32 reciprocal, and its residual ``g - q * scale`` as one fused
# multiply-add; the port rounds as the compiled reference does
_INV_127 = torch.tensor(1 / 127.0, dtype=torch.float32).item()


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization → (q int8, float32 scale)."""
    absmax = g.abs().max() + 1e-12
    scale = absmax * _INV_127
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def psum_compressed(grads: Tree, axis: str, error_state: Tree,
                    mesh) -> Tuple[Tree, Tree]:
    """All-reduce int8-compressed gradients with error feedback over
    ``axis`` of ``mesh`` (a ``ShardMesh``).  Each leaf is sharded,
    ``(n_shards, ...)``: shard ``s``'s gradient at ``[s]``.

    Each shard adds its residual, quantizes with its own scale and keeps
    the new residual; the int8 payloads are summed in int32 and the scales
    summed, and the mean is taken with the mean scale (the reference's
    approximation, which error feedback absorbs).  → (the mean-reduced
    gradients, on every shard; the new error state)."""
    n = mesh.axis_size(axis)
    reduced, errors = {}, {}
    for name, g in grads.items():
        g32 = g.to(torch.float32) + error_state[name]
        shape = (-1,) + (1,) * (g32.dim() - 1)
        absmax = g32.abs().reshape(len(g32), -1).amax(1).reshape(shape) + 1e-12
        scale = absmax * _INV_127                    # each shard's own
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        errors[name] = torch.addcmul(g32, q.to(torch.float32), scale,
                                     value=-1)
        summed = mesh.psum(q.to(torch.int32), axis)
        scale_sum = mesh.psum(scale, axis)
        reduced[name] = summed.to(torch.float32) * (scale_sum / n) / n
    return reduced, errors
