#!/usr/bin/env python3
"""Time kernel 11's bf16 body at several depths of its K/V ring.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/flash_slots.py [--slots 2 3 4]

For each depth it compiles ``src/repro_torch/kernels/csrc/flash_attention.cu``
with ``kSlots`` set to that depth (nvcc with the port's flags, all depths
at once) into ``build/flash_slots/``, loads each library with ctypes,
holds its bf16 output against ``flash_attention_plain`` within
``tolerance``, and times it with CUDA events at starcoder2-3b's prefill
shape (B 4, S 2048, H 24, KV 2, hd 128, causal) and at B 1, S 256, the
depths in turns (forward, then backward).  Prints the card's name and
power limit, then one JSON line per depth and shape: the mean of the
turns in ms, each turn, achieved TFLOP/s and the tolerance ratio.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"prefill_b4_s2048": ((4, 2048, 24, 2, 128), 20),
          "b1_s256": ((1, 256, 24, 2, 128), 200)}


def build(slots: list[int]) -> dict:
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention.cu").read_text()
    marker = "constexpr int kSlots = 2;"
    assert marker in src, "the source no longer sets kSlots = 2"
    out = ROOT / "build" / "flash_slots"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in slots:
        cu = out / f"slots{n}.cu"
        cu.write_text(src.replace(marker, f"constexpr int kSlots = {n};"))
        procs[n] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(out / f"slots{n}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for kSlots = {n}:\n{log}")
        fn = ctypes.CDLL(str(out / f"slots{n}.so")).flash_attention
        argtypes, restype = _build.SIGNATURES["flash_attention"]
        fn.argtypes, fn.restype = list(argtypes), restype
        libs[n] = fn
    return libs


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--slots", type=int, nargs="+", default=[2, 3, 4])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_slots: needs a CUDA card", file=sys.stderr)
        return 1
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build(args.slots)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, q, k, v):
        B, Sq, H, hd = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, k.shape[1], H, k.shape[2], hd, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(hd), 1,
                 0, 1, 0, 1, stream)
        assert err == 0, f"CUDA error {err}"
        return out

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    gen = torch.Generator(device="cuda").manual_seed(15)
    for label, ((B, S, H, KV, hd), reps) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        want = fa.flash_attention_plain(q, k, v)
        ops = 4 * B * H * hd * S * (S + 1) // 2
        turns = {n: [] for n in libs}
        for order in (list(libs), list(libs)[::-1]):
            for n in order:
                turns[n].append(event_ms(lambda: call(libs[n], q, k, v),
                                         reps))
        for n, ms in turns.items():
            ratio = fa.tolerance_ratio(call(libs[n], q, k, v), want)
            assert ratio <= 1.0, (n, label, ratio)
            mean = sum(ms) / len(ms)
            print(json.dumps({"slots": n, "shape": label, "ms": mean,
                              "turns_ms": ms, "tflops": ops / mean / 1e9,
                              "tolerance_ratio": ratio}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
