#!/usr/bin/env python3
"""Where a serving step's time goes on the card: ``Model.apply`` (the
prefill) and ``decode_step`` of one arch at full width, random weights.

    python3 scripts/prefill_profile.py --arch recurrentgemma-2b \\
        [--batch 4] [--seq 2048] [--layers N] [--decode 16] [--top 12]

After a warm-up call it times ``--reps`` prefills untraced (host wall
clock around a synchronize), then traces one prefill and ``--decode``
decode steps under ``torch.profiler`` (CUDA activity) and prints, for
each: the untraced wall seconds, the device's busy time (the union of
its kernel, copy and set intervals), the idle share (1 - busy / traced
wall), and the ``--top`` kernels by summed device time with their call
counts; kernel 11's calls appear as ``flash_attention_*``.
``--layers`` cuts the depth (``cfg.scaled(num_layers=N)``).  The last
line is a JSON object of those numbers.  Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _trace(torch, fn, top: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    busy = _busy_us((ev.time_range.start, ev.time_range.end)
                    for ev in dev) / 1e6
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in dev:
        by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
        by_name[ev.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"traced_wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / wall, "kernels": len(dev),
            "top_ms": [(name[:90], round(ms, 4), n)
                       for name, (ms, n) in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.scaled(num_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = Model(cfg, device=dev).init(gen)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                         generator=gen, device=dev)
    batch = {"tokens": toks}
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": torch.randn(
            (args.batch, args.seq, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)}
    model.apply(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        model.apply(batch)
    torch.cuda.synchronize()
    prefill_wall = (time.perf_counter() - t0) / args.reps
    prefill = _trace(torch, lambda: model.apply(batch), args.top)

    cache = model.init_cache(args.batch, args.decode + 1)
    first = (batch["embeddings"][:, :1] if "embeddings" in batch
             else toks[:, 0])
    model.decode_step(cache, first, 0)                 # warm-up

    def decode():
        for t in range(1, args.decode + 1):
            model.decode_step(cache, first, t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) / args.decode
    cache = model.init_cache(args.batch, args.decode + 1)
    model.decode_step(cache, first, 0)
    steps = _trace(torch, decode, args.top)

    out = {"card": card, "arch": cfg.name, "layers": cfg.num_layers,
           "batch": args.batch, "seq": args.seq,
           "prefill_wall_s": prefill_wall, "prefill": prefill,
           "decode_steps": args.decode, "decode_wall_ms_per_step":
           step_wall * 1e3, "decode": steps}
    for part in ("prefill", "decode"):
        p = out[part]
        print(f"{part}: traced wall {p['traced_wall_s']:.4f} s, device busy "
              f"{p['busy_s']:.4f} s, idle share {p['idle_share']:.4f}, "
              f"{p['kernels']} kernels; top: {p['top_ms']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
