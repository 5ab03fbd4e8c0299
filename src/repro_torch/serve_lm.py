"""Serve an LM with batched requests: prefill, then greedy decode.

Counterpart of the reference's ``examples/serve_lm.py`` loop (which serves
reduced jamba, so that its cache holds attention KV and Mamba conv/ssm
state): the ragged prompts are teacher-forced through ``decode_step``
together (pad token 0 past a prompt's end, as the reference feeds it), then
every request decodes greedily.  On the card each decode step runs the
hand-written decode attention kernel once per attention layer (none for
MLA or Mamba layers).

The serving workload is defined once, here: ``BATCH`` requests with prompt
lengths drawn from ``SEED`` in ``PROMPT_LENS``, ``N_NEW`` new tokens each,
a ``MAX_CACHE``-row cache, random weights from ``SEED``
(``workload_prompts``).  ``chip_smoke.py`` and ``profile_tpch.py --lm``
import it.  Run on the card:

    PYTHONPATH=src python -m repro_torch.serve_lm [--arch llama3.2-3b]

``--arch`` takes any of the ten configurations, at full depth: one 80 GB
card holds deepseek-v2-lite-16b, falcon-mamba-7b, whisper-medium and
llava-next-mistral-7b whole, not phi3.5-moe-42b-a6.6b or jamba-v0.1-52b
(``chip_smoke.py`` phase 6b serves those at 16 of their 32 layers).  An
encoder-decoder (whisper) is served with random frame embeddings from
``SEED`` (``workload_frames``), encoded once before the prefill; a VLM
(llava) decodes text tokens only, as the reference's ``decode_step`` does.
It prints one JSON line: prefill and decode tokens/s, the median decode
step, the kernel's launches and the peak device memory.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, Sequence

import numpy as np
import torch

from .configs import get_config
from .kernels import build
from .models.lm import CausalLM

# the serving workload
ARCH = "llama3.2-3b"
BATCH = 8
PROMPT_LENS = (64, 512)      # prompt lengths drawn in [lo, hi]
N_NEW = 32
MAX_CACHE = 8192
SEED = 19920101              # weights and prompts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(model: CausalLM, prompts: Sequence[Sequence[int]], n_new: int,
          max_cache: int, frames=None) -> Dict:
    """Prefill ``prompts`` (one request each) and decode ``n_new`` greedy
    tokens per request with a cache of ``max_cache`` rows.  An
    encoder-decoder needs ``frames`` (B,enc_seq,d), encoded into the
    cache's ``enc_out`` before the prefill (its time counts as prefill).

    → {"tokens": n_new token ids per request, "prefill_s", "decode_s",
    "step_s": host seconds of each decode step (each ends in a device
    synchronisation, as the reference's loop reads the tokens back every
    step), "prompt_tokens": the prompts' total length, "prefill_steps"}."""
    dev = model.device
    batch = len(prompts)
    maxp = max(len(p) for p in prompts)
    padded = np.zeros((maxp, batch), np.int64)
    for b, p in enumerate(prompts):
        padded[:len(p), b] = np.asarray(p, np.int64)
    toks = torch.from_numpy(padded).to(dev)
    vocab = model.cfg.vocab
    cache = model.init_cache(batch, max_cache)

    _sync(dev)
    t0 = time.perf_counter()
    if model.cfg.enc_layers:
        if frames is None:
            raise ValueError(f"{model.cfg.name} needs frames")
        cache["enc_out"] = model.encode(torch.as_tensor(frames, device=dev))
    for i in range(maxp):
        last_logits, cache = model.decode_step(cache, toks[i][:, None])
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    tok = last_logits[..., :vocab].argmax(dim=-1)          # (B,1)
    out, step_s = [], []
    t0 = time.perf_counter()
    for _ in range(n_new):
        t = time.perf_counter()
        out.append(tok)
        logits, cache = model.decode_step(cache, tok)
        tok = logits[..., :vocab].argmax(dim=-1)
        _sync(dev)
        step_s.append(time.perf_counter() - t)
    decode_s = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1).cpu().tolist() if out else [[]] * batch
    return {"tokens": tokens, "prefill_s": prefill_s, "decode_s": decode_s,
            "step_s": step_s, "prompt_tokens": int(sum(len(p) for p in prompts)),
            "prefill_steps": maxp}


def serve_metrics(result: Dict) -> Dict:
    """Prefill tokens/s (the prompts' real tokens over the prefill time),
    decode tokens/s (new tokens over the decode time) and the median decode
    step in ms."""
    n_new = len(result["tokens"][0]) * len(result["tokens"])
    return {"prefill_tokens_per_s": result["prompt_tokens"] / result["prefill_s"],
            "decode_tokens_per_s": n_new / result["decode_s"],
            "median_step_ms": 1e3 * statistics.median(result["step_s"])}


def random_prompts(rng: np.random.Generator, batch: int, lo: int, hi: int,
                   vocab: int):
    """``batch`` prompts of lengths drawn in [lo, hi], tokens in [0, vocab)."""
    return [rng.integers(0, vocab, int(n)) for n in rng.integers(lo, hi + 1, batch)]


def workload_prompts(vocab: int):
    """The serving workload's ``BATCH`` prompts, drawn from ``SEED``."""
    return random_prompts(np.random.default_rng(SEED), BATCH, *PROMPT_LENS, vocab)


def workload_frames(cfg, batch: int = BATCH) -> np.ndarray:
    """An encoder-decoder's frame embeddings for the workload's requests:
    standard normal (batch, enc_seq, d_model) float32 from ``SEED``."""
    return np.random.default_rng(SEED).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model), np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=ARCH)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    model = CausalLM(cfg, seed=SEED)                # the card, or raise
    prompts = workload_prompts(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    frames = workload_frames(cfg) if cfg.enc_layers else None
    result = serve(model, prompts, N_NEW, MAX_CACHE, frames)
    print(json.dumps({
        "arch": cfg.name, "device": torch.cuda.get_device_name(model.device),
        "batch": BATCH, "prompt_lengths": [len(p) for p in prompts],
        "n_new": N_NEW, "max_cache": MAX_CACHE,
        **serve_metrics(result),
        "decode_attention_launches": build.launch_counts()["decode_attention"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(model.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
