#!/usr/bin/env python3
"""Time the kernel wrappers of two checkouts in turns on one card, and
where one wrapper call's host time goes.

    PYTHONPATH=src python3 -m repro_torch.kernel_turns OTHER_ROOT \
        [--checks groupby,expand] [--out FILE]

runs ``chip_smoke.py``'s phase-3 checks named by ``--checks`` (``filter``,
``groupby``, ``probe``, ``expand``, ``topk``, ``decode``; all six by
default) from this checkout's script: the same inputs from its seed, each
kernel held against its own checkout's plain version, the same timers
(``ms``, ``device_ms``, ``host_ms``, ``plain_ms``, ``library_ms``, and
``evicted_ms`` for the probe), four times, each in a process of its own
that imports ``repro_torch`` from one checkout, in the order OTHER, this,
this, OTHER (one process a check; the first of a checkout builds its
kernels).  Then it times, in this checkout, the host path of one wrapper
call (top-k, decode attention, group-by sum, join expansion, hash probe)
piece by piece: the whole call, the entry point alone (the ctypes call and
the launch), each check and allocation, and the helpers a wrapper used
before (a set of device types, a ``torch.cuda.Stream`` object, a
``torch.cuda.device`` context, an empty scratch tensor).  ``--pieces``
alone runs only that.  Every line is one JSON object with the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# --checks name -> chip_smoke.py's phase-3 check
CHECKS = {"filter": "check_filter", "groupby": "check_groupby",
          "probe": "check_probe", "expand": "check_expand",
          "topk": "check_topk", "decode": "check_decode_attention"}


def turns(other: Path, card: str, checks: list) -> list:
    """The named checks of OTHER, this, this, OTHER, each in a process of
    its own (``chip_smoke.run_check``)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    lines = []
    for turn, root in enumerate((other, ROOT, ROOT, other)):
        for check in checks:
            lines.append({"turn": turn, "checkout": str(root), "card": card,
                          **chip_smoke.run_check(CHECKS[check], root / "src")})
    return lines


def pieces(card: str) -> list:
    """Host ms of one call of each piece of the wrappers' host paths, at
    ClickBench's top-k call (433 keys, k=10), the server's decode call,
    small group-by and join calls and hash_probe's calls at 10,000 keys and
    at Q3's second call."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from .kernels import build, ops
    from .kernels import groupby_agg as ga
    from .kernels import hash_probe as hp
    from .kernels import join_expand as je
    from .kernels.decode_attention import _workspace, split_count
    from .relational.join import join_match

    dev = torch.device("cuda", 0)
    index = 0
    rng = np.random.default_rng(chip_smoke.SEED)
    keys = torch.from_numpy(rng.permutation(433).astype(np.float32)).to(dev)
    idx_out = torch.empty(10, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal((8, 24, 128), np.float32)).to(
        dev, torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((8, 8192, 8, 128), np.float32)).to(
        dev, torch.bfloat16)
    n = torch.from_numpy(rng.integers(64, 577, 8).astype(np.int32)).to(dev)
    out = torch.empty_like(q)
    q4 = q[:, :, None]
    kl = kv.transpose(1, 2).contiguous()
    mask = (torch.arange(8192, device=dev)[None, :] < n[:, None])[:, None, None, :]
    build.lib()
    stream = build.current_stream(index)
    n_split = split_count(8, 8, 3, 8192, build.sm_count(index))
    tickets, part = _workspace(index, stream, 8 * 24, 8 * 24 * n_split * 130, dev)
    topk_entry = build._entries["topk_select"]
    decode_entry = build._entries["decode_attention"]
    # groupby_sum at 1,000 rows (V=5, G=128: ClickBench's columns, a size
    # whose device time is below its host time) and join_expand at Q5's
    # two-key join (968,874 runs, 38,705 outputs in 2^16 here)
    gids = torch.zeros(1000, dtype=torch.int32, device=dev)
    vals = torch.ones((1000, 5), device=dev)
    gout = torch.empty((128, 5), device=dev)
    acc, gtickets = ga._workspace(index, stream, 128 * 5, 1, dev)
    rows = ga.tile_rows(5, 8)
    part_bytes, smem = ga.smem_layout(128, 5, 5, rows)
    groupby_entry = build._entries["groupby_sum"]
    order, lo, counts = join_match(
        torch.from_numpy(rng.integers(0, 50_000, 968_874)).to(dev),
        torch.from_numpy(rng.choice(50_000, 2_003, replace=False)).to(dev))
    t_pad = ops.bucket_size(int(counts.sum()))
    outs = ops.join_expand(order, lo, counts, counts, t_pad)
    tiles, helpers = je.expand_grid(lo.shape[0], t_pad, build.sm_count(index))
    ws = je._workspace(index, stream, dev)
    join_fn = build._entries["join_expand"]

    def join_entry():   # with the workspace's bookkeeping, as the wrapper
        with ws.lock:
            status, base, epoch = ws.next_launch(tiles)
            err = join_fn(counts.data_ptr(), lo.data_ptr(), counts.data_ptr(),
                          order.data_ptr(), outs[0].data_ptr(),
                          outs[1].data_ptr(), outs[2].data_ptr(), lo.shape[0],
                          order.shape[0], t_pad, tiles, helpers,
                          status.data_ptr(), ws.counter.data_ptr(), base, epoch,
                          stream)
            assert err == 0
            ws.base += tiles + helpers

    def device_context():
        with torch.cuda.device(dev):
            pass

    # hash_probe at Q5's second call at SF1 (10,000 keys into a 5-row
    # build) and at Q3's second (chip_smoke.PROBE_Q3)
    probe_in = {}
    for what, (n_probe, n_build, share) in (
            ("10,000 keys", (10_000, 5, 0.2)),
            ("Q3's second call", chip_smoke.PROBE_Q3)):
        build_keys, s, sk, sr = chip_smoke._probe_table(rng, n_build, dev)
        pk = np.where(rng.random(n_probe) < share, rng.choice(build_keys, n_probe),
                      6_000_000 + rng.integers(0, 6_000_000, n_probe))
        probe_in[what] = (ops.map_probe_keys(s, torch.from_numpy(pk).to(dev)), sk, sr)
    probe_entry = build._entries["hash_probe"]
    p32, sk, sr = probe_in["10,000 keys"]
    prow, pfound = ops.hash_probe(p32, sk, sr)

    def probe_checks():
        build.on_cpu(p32, sk, sr)
        for t in (p32, sk, sr):
            build.require(t, "t", torch.int32, 1)

    cases = {
        **{f"hash_probe: the wrapper ({what})":
           (lambda a: lambda: ops.hash_probe(*a))(args)
           for what, args in probe_in.items()},
        "hash_probe: the entry point alone": lambda: probe_entry(
            p32.data_ptr(), sk.data_ptr(), sr.data_ptr(), prow.data_ptr(),
            pfound.data_ptr(), 10_000, sk.shape[0], 32, stream),
        "hash_probe: build.on_cpu and three build.require": probe_checks,
        "hash_probe: build.on_cpu and the fused check": lambda: (
            build.on_cpu(p32, sk, sr), hp._require_int32_vectors(p32, sk, sr)),
        "hash_probe: its two outputs (torch.empty)": lambda: (
            torch.empty(10_000, dtype=torch.int32, device=dev),
            torch.empty(10_000, dtype=torch.bool, device=dev)),
        "hash_probe: one allocation, two views": lambda: (
            lambda b: (b[:40_000].view(torch.int32), b[40_000:].view(torch.bool)))(
            torch.empty(50_000, dtype=torch.uint8, device=dev)),
        "hash_probe: get_device and build.current_stream": lambda: (
            build.current_stream(p32.get_device())),
        "topk_select: the wrapper": lambda: ops.topk_select(keys, 10),
        "topk_select: torch.topk": lambda: torch.topk(keys, 10, largest=False),
        "topk_select: the entry point alone": lambda: topk_entry(
            keys.data_ptr(), 433, 10, 512, None, idx_out.data_ptr(), stream),
        "decode_attention: the wrapper": lambda: ops.decode_attention(q, kv, kv, n),
        "decode_attention: SDPA": lambda: F.scaled_dot_product_attention(
            q4, kl, kl, attn_mask=mask, enable_gqa=True),
        "decode_attention: the entry point alone": lambda: decode_entry(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), n.data_ptr(),
            out.data_ptr(), part.data_ptr(), tickets.data_ptr(), 8, 8192, 24,
            8, 128, n_split, 1, stream),
        "groupby_sum: the wrapper (1,000 rows)": lambda: ops.groupby_sum(
            gids, vals, 128),
        "groupby_sum: the entry point alone": lambda: groupby_entry(
            gids.data_ptr(), vals.data_ptr(), acc.data_ptr(),
            gtickets.data_ptr(), gout.data_ptr(), 1000, 5, 128, 1, 5, 1000,
            8, rows, part_bytes, smem, 1, 0, stream),
        "join_expand: the wrapper": lambda: ops.join_expand(
            order, lo, counts, counts, t_pad),
        "join_expand: the entry point alone": join_entry,
        "join_expand: its three outputs (torch.empty)": lambda: [
            torch.empty(t_pad, dtype=dt, device=dev)
            for dt in (torch.int64, torch.int64, torch.bool)],
        "join_expand: build.on_cpu and four build.require": lambda: [
            build.on_cpu(order, lo, counts, counts)] + [
            build.require(t, "t", torch.int64, 1) for t in (order, lo, counts, counts)],
        "decode_attention: split_count and sm_count": lambda: split_count(
            8, 8, 3, 8192, build.sm_count(index)),
        "decode_attention: the workspace lookup": lambda: _workspace(
            index, stream, 8 * 24, 8 * 24 * n_split * 130, dev),
        "build.on_cpu": lambda: build.on_cpu(keys),
        "a set of device types": lambda: {t.device.type for t in (keys,)},
        "build.require": lambda: build.require(keys, "keys", torch.float32, 1),
        "torch.empty(10)": lambda: torch.empty(10, dtype=torch.int32, device=dev),
        "torch.empty(0)": lambda: torch.empty(0, dtype=torch.int64, device=dev),
        "torch.empty_like(q)": lambda: torch.empty_like(q),
        "build.current_stream": lambda: build.current_stream(index),
        "torch.cuda.current_stream(dev).cuda_stream": lambda: (
            torch.cuda.current_stream(dev).cuda_stream),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "a torch.cuda.device context": device_context,
        "build.count_launch": lambda: build.count_launch("topk_select"),
    }
    lines = [{"piece": name, "host_ms": chip_smoke.host_ms(fn, iters=2000),
              "card": card} for name, fn in cases.items()]
    build.reset_launch_counts()
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--checks", default=",".join(CHECKS),
                    help="comma-separated checks to time in turns "
                         f"(default: all of {', '.join(CHECKS)})")
    ap.add_argument("--pieces", action="store_true",
                    help="only the host path's pieces, in this checkout")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    if not args.pieces and not args.other:
        ap.error("give the other checkout's root, or --pieces")
    checks = [c for c in args.checks.split(",") if c]
    unknown = sorted(set(checks) - set(CHECKS))
    if unknown:
        ap.error(f"unknown checks {unknown}; choose from {', '.join(CHECKS)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    lines = [] if args.pieces else turns(Path(args.other).resolve(), card, checks)
    lines += pieces(card)
    for row in lines:
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
