"""Train a small qwen3-family model for N steps — counterpart of the
reference's ``examples/train_lm.py``.

The same configuration (``make_cfg``: the qwen3-4b sibling of 6 layers,
d_model 384, float32), the same synthetic token stream from the same
numpy draws (``synthetic_stream``), the same optimizer settings and the
same checks: the loss must fall by more than 0.2, and a checkpoint of the
parameters written and read back through ``runtime/checkpoint.py`` must
give them back exactly.  Weights are random (a float32 ``CausalLM`` from
``--seed``), not the reference's draws.  Run on the card:

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 200]

It prints the loss every 20 steps and one JSON line at the end: first and
last loss, steps/s and the checkpoint round trip's max |delta|.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .configs import get_config
from .configs.base import ArchConfig
from .runtime.checkpoint import load_npz, save_npz
from .training.optimizer import OptConfig
from .training.train_step import init_train_state, make_train_step


def make_cfg() -> ArchConfig:
    """The ~30M-parameter sibling of qwen3-4b (GQA, qk_norm, swiglu)."""
    base = get_config("qwen3-4b")
    return dataclasses.replace(
        base, n_layers=6, d_model=384, n_heads=6, n_kv_heads=2, head_dim=64,
        d_ff=1536, vocab=2048, dtype="float32")


def synthetic_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                     device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """A Markov-ish token stream (learnable structure, not pure noise):
    each token one of two successors of the previous one, 5% uniform
    noise.  The reference's numpy draws in the reference's order, so one
    seed gives the reference's tokens; int64 tensors on ``device`` (the
    CPU by default)."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, size=(vocab, 2))
    state = rng.integers(0, vocab, size=(batch,))
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = state
        for i in range(1, seq + 1):
            pick = rng.integers(0, 2, size=batch)
            noise = rng.random(batch) < 0.05
            nxt = trans[toks[:, i - 1], pick]
            toks[:, i] = np.where(noise, rng.integers(0, vocab, batch), nxt)
        state = toks[:, -1]
        t = torch.from_numpy(toks.astype(np.int64)).to(device)
        yield {"tokens": t[:, :-1], "targets": t[:, 1:]}


def run(steps: int = 200, batch: int = 8, seq: int = 128, seed: int = 0,
        device=None, ckpt: Optional[str] = None, log=print) -> Dict:
    """Train ``make_cfg()`` for ``steps`` steps on ``device`` (the card
    unless "cpu"), then round-trip the parameters through a checkpoint at
    ``ckpt`` (a temporary file by default).  → the losses, steps/s and the
    round trip's max |delta|."""
    cfg = make_cfg()
    step_fn = make_train_step(
        cfg, OptConfig(lr=3e-3, warmup_steps=10, total_steps=steps),
        device=device)
    dev = step_fn.model.device
    state = init_train_state(cfg, device=dev, seed=seed)
    stream = synthetic_stream(cfg.vocab, batch, seq, device=dev)
    losses = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        state, metrics = step_fn(state, next(stream))
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == 1:
            log(f"step {step:4d}  loss {losses[-1]:.4f}  gnorm "
                f"{float(metrics['grad_norm']):.2f}  "
                f"{(time.perf_counter() - t0) / step:.3f}s/step")
    seconds = time.perf_counter() - t0

    # checkpoint → restore: the parameters must come back exactly
    names = list(state["params"])
    flat = {f"p{i}": state["params"][n].cpu().numpy()
            for i, n in enumerate(names)}
    with tempfile.TemporaryDirectory() as tmp:
        path = ckpt or os.path.join(tmp, "train_lm.npz")
        save_npz(path, flat, manifest={"step": steps, "names": names})
        arrays, manifest = load_npz(path)
    diff = max(float(np.abs(arrays[f"p{i}"] - flat[f"p{i}"]).max())
               for i in range(len(names)))
    if manifest["names"] != names or len(arrays) != len(names):
        raise AssertionError("checkpoint: the parameter names came back "
                             "changed")
    return {"arch": f"{cfg.name}-mini", "params": cfg.param_count(),
            "steps": steps, "batch": batch, "seq": seq,
            "first_loss": losses[0], "last_loss": losses[-1],
            "improved": losses[-1] < losses[0] - 0.2,
            "steps_per_s": steps / seconds, "seconds": seconds,
            "checkpoint_step": manifest["step"],
            "checkpoint_max_abs_diff": diff, "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)
    cfg = make_cfg()
    print(f"model: {cfg.name}-mini  params={cfg.param_count() / 1e6:.1f}M")
    out = run(args.steps, args.batch, args.seq, ckpt=args.ckpt)   # the card
    print(f"loss {out['first_loss']:.3f} → {out['last_loss']:.3f} "
          f"({'IMPROVED' if out['improved'] else 'no improvement!'})")
    print(f"checkpoint round-trip @step {out['checkpoint_step']}: "
          f"max|Δ|={out['checkpoint_max_abs_diff']}")
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}))
    return 0 if out["improved"] and out["checkpoint_max_abs_diff"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
