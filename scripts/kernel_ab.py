#!/usr/bin/env python3
"""Time kernels' timed points in two checkouts, in turns, on one card.

Run from the root of a checkout, on a machine with one CUDA card, with
the root of another checkout of the repo (say an unpacked ``git archive``
of the parent commit) as the argument:

    python3 scripts/kernel_ab.py OTHER [--kernels gf_per_item_fold ...]
                                       [--turns N]

(``--kernels gf_matmul_batched gf_matmul_cols_batched gf_matmul`` for the
shared-matrix kernels 1, 2 and 8; ``--kernels gf01_matmul_batched
gf_delta_update`` for the 0/1 kernel 3 and the single-stripe delta 9;
``--kernels flash_attention`` for kernel 11, ``chip_smoke.flash_spec``.)
For each checkout in the order this, other, other, this (``--turns N``
repeats that order N times), a fresh process
in that checkout builds its kernel library and runs this checkout's
``chip_smoke.kernel_specs`` and ``flash_spec`` on that checkout's
package: every timed point of the named kernels (default: kernels 4-7),
with the same inputs and timers for both and each checkout's wrappers and
kernels (``cuda_ms`` for the wrapper call, ``kernel_device_ms`` for the
kernel's device time).
Each point's output, from the same seeded inputs on both sides, is
hashed (SHA-256 of its bytes): ``bit_equal`` says whether every turn of
both checkouts gave the same bytes, so a change that must leave a kernel's
results alone (kernel 11's unstriped calls under query stripes) is held
to the other checkout's kernel bit for bit.
Prints the card's name and power limit, then one JSON line per kernel,
case and point with each turn's wrapper and kernel ms, each side's
median wrapper ms and ``bit_equal``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("gf_per_item", "gf_per_item_fold", "gf_delta_apply_batched",
           "gf_delta_only_batched")

# run inside one checkout: its package, this checkout's chip_smoke
CHILD = r"""
import hashlib, json, sys
sys.path[:0] = ["src", sys.argv[2]]
import numpy as np, torch
import chip_smoke as cs
from repro_torch.kernels import _build
_build.library()
dev = torch.device("cuda")
names = set(sys.argv[1].split(","))
for spec in cs.kernel_specs(np, torch, dev) + [cs.flash_spec(torch, dev)]:
    if spec["name"] not in names:
        continue
    for cname, case in spec["cases"].items():
        for label, shape, reps in case["timed"]:
            args = case["make"](*shape)
            call = lambda: case["kernel"](*args)
            ms = cs.cuda_ms(torch, call, reps)
            cuda_name = spec["cuda_name"]
            if callable(cuda_name):
                cuda_name = cuda_name(args)
            k = cs.kernel_device_ms(torch, call, reps, cuda_name)
            out = call()
            digest = (hashlib.sha256(out.contiguous().view(torch.uint8)
                                     .cpu().numpy().tobytes()).hexdigest()
                      if isinstance(out, torch.Tensor) else None)
            print(json.dumps(dict(kernel=spec["name"], case=cname,
                                  point=label, ms=ms,
                                  kernel_ms=k[0] if isinstance(k, tuple)
                                  else k, digest=digest)), flush=True)
"""


def run(checkout: Path, kernels: str) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", CHILD, kernels, str(ROOT)],
                          cwd=checkout, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS))
    ap.add_argument("--turns", type=int, default=1)
    a = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernels = ",".join(a.kernels)
    rows: dict[tuple, dict] = {}
    other = a.other.resolve()
    order = (("this", ROOT), ("other", other), ("other", other),
             ("this", ROOT)) * a.turns
    for tag, root in order:
        for r in run(root, kernels):
            row = rows.setdefault((r["kernel"], r["case"], r["point"]),
                                  dict(kernel=r["kernel"], case=r["case"],
                                       point=r["point"]))
            row.setdefault(f"{tag}_ms", []).append(r["ms"])
            row.setdefault(f"{tag}_kernel_ms", []).append(r["kernel_ms"])
            row.setdefault("digests", []).append(r["digest"])
    for row in rows.values():
        for tag in ("this", "other"):
            row[f"{tag}_median_ms"] = statistics.median(row[f"{tag}_ms"])
        digests = row.pop("digests")
        row["bit_equal"] = (None if None in digests
                            else len(set(digests)) == 1)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
