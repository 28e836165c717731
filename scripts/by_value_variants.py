#!/usr/bin/env python3
"""Time kernels 4-7 built with other launch geometries.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/by_value_variants.py [--variants "" kGroup=4 ...]

``src/repro_torch/kernels/csrc/gf256.cu`` sets its by-value kernels'
geometry in three constants: ``kSmallThreads`` (threads a block),
``kGroup`` (operand loads a thread issues together) and ``kBlocksPerSm``
(the grid cap; 0 launches one thread per unit with no grid-stride loop).
Each variant is a space-separated list of ``NAME=VALUE`` settings of
them (the empty string is the source as it stands).  The script writes
each variant's source with those constants replaced, compiles them all at
once with the port's nvcc flags into ``build/by_value_variants/``
(printing ptxas's registers of the kernels), then times the timed points
of ``chip_smoke.kernel_specs`` for kernels 4-7 with each variant's library
in turns (forward, then backward), each output checked against the plain
version: CUDA-event ms per wrapper call and the kernel's device ms per
call from a profiler trace.  Prints the card's name and power limit, then
one JSON line per variant and point.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNELS = ("gf_per_item", "gf_per_item_fold", "gf_delta_apply_batched",
           "gf_delta_only_batched")
DEFAULT = ["", "kGroup=4", "kGroup=1", "kBlocksPerSm=0",
           "kSmallThreads=128"]


def build(variants: list[str]) -> dict:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "by_value_variants"
    out.mkdir(parents=True, exist_ok=True)
    base = (_build.CSRC / "gf256.cu").read_text()
    procs = {}
    for i, v in enumerate(variants):
        src = base
        for setting in v.split():
            name, value = setting.split("=")
            src, n = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", src)
            assert n == 1, f"the source sets {name} {n} times"
        cu = out / f"v{i}.cu"
        cu.write_text(src)
        procs[v] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(out / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (v, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v!r}:\n{log}")
        regs = {}
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and name and ("per_item_kernel" in name
                               or "delta_batched_kernel" in name):
                short = re.search(r"(per_item_kernel|delta_batched_kernel)"
                                  r"I(L[^E]*E)+", name)
                regs[short.group(0)] = int(m.group(1))
        print(json.dumps(dict(variant=v, registers=regs)), flush=True)
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        for fn_name, (argtypes, restype) in _build.SIGNATURES.items():
            if fn_name.startswith("gf_"):
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = list(argtypes), restype
        libs[v] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("by_value_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=DEFAULT)
    a = ap.parse_args()
    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.card_line(), flush=True)
    libs = build(a.variants)
    dev = torch.device("cuda")
    points = []
    for spec in cs.kernel_specs(np, torch, dev):
        if spec["name"] in KERNELS:
            for cname, case in spec["cases"].items():
                for label, shape, reps in case["timed"]:
                    points.append((spec, cname, case, label,
                                   case["make"](*shape), reps))
    rows = {}
    for v in a.variants + a.variants[::-1]:
        _build._LIBRARY = libs[v]
        for spec, cname, case, label, args, reps in points:
            call = lambda: case["kernel"](*args)         # noqa: E731
            assert torch.equal(call(), case["plain"](*args)), (v, cname)
            ms = cs.cuda_ms(torch, call, reps)
            k, _ = cs.kernel_device_ms(torch, call, reps, spec["cuda_name"])
            row = rows.setdefault((v, spec["name"], cname, label), dict(
                variant=v, kernel=spec["name"], case=cname, point=label))
            row.setdefault("ms", []).append(ms)
            row.setdefault("kernel_ms", []).append(k)
    for row in rows.values():
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
