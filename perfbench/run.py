#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``repro_torch`` on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It finds the cell in ``BENCHMARK.json`` and
its files by name (``yardstick/cells.py``), sets up the program as the
cell's driver says (``drivers/<kind>.py``), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit (also the last lines of standard error).

It exits with another code than 0 and prints no result without a CUDA
card (or with fewer than the cell asks for), and when a module of JAX,
Flax or the JAX package (``repro``) is loaded once the window has closed.
``setup_s`` runs from the start of this script to the start of the
window.  The kernels build into ``build/repro_torch_kernels`` inside the
checkout, once; the result line's ``setup_parts`` gives the seconds their
load took inside ``setup_s`` and whether this run built them.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(Path(__file__).resolve().parent)]

def _summary(readings: dict) -> dict:
    """The readings the result line keeps: each side's losses, not its
    per-leaf norms."""
    out = {}
    for side, r in readings.items():
        if isinstance(r, dict) and "losses" in r:
            out[side] = {"losses": r["losses"]}
        else:
            out[side] = r
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from yardstick import card, cells, checks, harness
    chips = next(w["chips"] for w in cells.load_benchmark(ROOT)["workloads"]
                 if w["name"] == args.workload)
    why = card.missing(chips)
    if why:
        print(f"perfbench: {why}; no result", file=sys.stderr)
        return 2
    import torch
    line = harness.run_workload(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda"), T0)
    bad = harness.foreign_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{bad}; no result", file=sys.stderr)
        return 3
    judged = line.pop("checks")
    line["card"] = card.power_limit()
    line["readings"] = _summary(line.pop("readings"))
    line["checks"] = judged
    checks.report(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
