#!/usr/bin/env python3
"""Time the by-value kernels built with other launch geometries.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/by_value_variants.py [--variants "" kGroup=4 ...]
        [--kernels gf_matmul_batched gf_matmul_cols_batched gf_matmul]

``src/repro_torch/kernels/csrc/gf256.cu`` sets its by-value kernels'
geometry in constants: ``kSmallThreads`` (threads a block), ``kGroup``
(operand loads a thread issues together) and ``kBlocksPerSm`` (the grid
cap; 0 launches one thread per unit with no grid-stride loop) for all of
them; for the shared-matrix kernels 1, 2 and 8 also ``kMat1Rows`` and
``kMat2Rows`` (output rows a thread of kernel 1 or 2 holds at once when
the batch fills the card), ``kMat1MinBlocks`` and ``kMat2MinBlocks``
(their ``__launch_bounds__`` blocks an SM, which cap their registers),
``kFillThreads`` (threads an SM below which rows are split across
threads) and ``kMatSmallGroup`` (input loads in flight in that case);
for the 0/1 kernel 3 ``kGf01FillBlocks`` (blocks an SM its tile body's
row split aims for) and ``kGf01DirectPercent`` (the rule between its
bodies: 0 takes the tile body always, a large value the direct body).
Each variant is a space-separated list of ``NAME=VALUE``
settings of them (the empty string is the source as it stands).  The
script writes each variant's source with those constants replaced,
compiles them all at once with the port's nvcc flags into
``build/by_value_variants/`` (printing ptxas's registers of the named
kernels and counts of some SASS instructions in each), then times the
timed points of ``chip_smoke.kernel_specs`` for the named kernels
(default: kernels 4-7; with ``gf_matmul_cols_batched``, also a (64, 64)
matrix, whose tables lie on the card) with each variant's library in
turns (forward, then backward), each output checked against the plain
version: CUDA-event ms per wrapper call and the kernel's device ms per
call from a profiler trace.  Prints the card's name and power limit, then
one JSON line per variant and point.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
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
# the __global__ functions whose registers and SASS are reported
CUDA_NAMES = ("per_item_kernel", "delta_batched_kernel",
              "matmul_batched_kernel", "matmul_cols_kernel",
              "gf01_tile_kernel", "gf01_direct_kernel", "delta_update_kernel")
SASS_OPS = ("LDC", "ULDC", "PRMT", "LOP3", "LDG", "STG", "BRA", "STL", "LDL")


def short_name(mangled: str) -> str | None:
    """``matmul_cols_kernel<CoefWords<4096>, 12>`` and the like, from a
    mangled name (None for other functions)."""
    for name in CUDA_NAMES:
        if name in mangled:
            rest = mangled.split(name, 1)[1]
            args = re.findall(r"CoefWordsILi(\d+)E|(DevWords)|Li(\d+)E|Lb(\d)E",
                              rest.split("EEv", 1)[0] + "EE")
            return name + "<" + ", ".join(
                (f"CoefWords<{a}>" if a else b or c or ("true" if d == "1"
                                                        else "false"))
                for a, b, c, d in args) + ">"
    return None


def sass_counts(so: Path, nvcc: str) -> dict:
    """Counts of ``SASS_OPS`` in each reported kernel of a library."""
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        name = short_name(fn.split("\n", 1)[0].strip())
        if name:
            body = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                              fn)
            out[name] = {op: sum(1 for b in body if b == op) for op in SASS_OPS}
    return out


def build(variants: list[str], kernels: set) -> dict:
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
                name = short_name(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name and _reported(name, kernels):
                regs[name] = int(m.group(1))
        sass = {n: c for n, c in sass_counts(out / f"v{i}.so",
                                             _build._nvcc()).items()
                if _reported(n, kernels)}
        print(json.dumps(dict(variant=v, registers=regs, sass=sass)),
              flush=True)
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        for fn_name, (argtypes, restype) in _build.SIGNATURES.items():
            fn = getattr(lib, fn_name, None)     # gf256.cu's entries only
            if fn is not None:
                fn.argtypes, fn.restype = list(argtypes), restype
        libs[v] = lib
    return libs


def _reported(name: str, kernels: set) -> bool:
    """Whether a short kernel name belongs to one of the timed kernels
    (of the shared-matrix kernels, only the 4,096-byte tier and the
    device tables: the tiers differ in the parameter size alone)."""
    if name.startswith("matmul_") and "<CoefWords<4096>" not in name \
            and "<DevWords" not in name:
        return False
    cuda = {"gf_per_item": "per_item_kernel",
            "gf_per_item_fold": "per_item_kernel",
            "gf_delta_apply_batched": "delta_batched_kernel",
            "gf_delta_only_batched": "delta_batched_kernel",
            "gf_matmul_batched": "matmul_batched_kernel",
            "gf_matmul": "matmul_batched_kernel",
            "gf_matmul_cols_batched": "matmul_cols_kernel",
            "gf01_matmul_batched": "gf01_",
            "gf_delta_update": "delta_update_kernel"}
    return any(name.startswith(cuda[k]) for k in kernels if k in cuda)


def large_cols_case(np, torch, dev) -> dict:
    """A (64, 64) matrix, 0 and 1 entries among the rest, for the cols
    kernel: 4,096 coefficients, above the largest parameter tier, so its
    tables lie on the card."""
    import chip_smoke as cs
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    rng = np.random.default_rng(64)
    A = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    A[::5, 0], A[1::5, 1] = 0, 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(64)
    return dict(make=lambda B, C: (A, torch.randint(
        0, 256, (B, 64, C), dtype=torch.uint8, device=dev, generator=gen)),
        kernel=gm.gf256_matmul_batched, plain=gm.gf256_matmul_batched_plain,
        work=lambda a: cs.matmul_work(np, *a),
        timed=[("b1024", (1024, 4096), 20), ("b64", (64, 4096), 200)])


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("by_value_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=DEFAULT)
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS))
    a = ap.parse_args()
    kernels = set(a.kernels)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.card_line(), flush=True)
    libs = build(a.variants, kernels)
    dev = torch.device("cuda")
    points = []
    specs = cs.kernel_specs(np, torch, dev)
    if "gf_matmul_cols_batched" in kernels:
        cols = next(sp for sp in specs if sp["name"] == "gf_matmul_cols_batched")
        cols["cases"]["decode_64x64"] = large_cols_case(np, torch, dev)
    for spec in specs:
        if spec["name"] in kernels:
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
