"""One run of a cell: the driver's run, then the result line.

``run_workload`` finds the cell, runs its driver, reads the per-layer
metrics of a traced run through their readers, judges the compared
numbers against the cell's limits and builds the result line; it does not
look for a card (``run.py`` does, before it), so the CPU tests drive it
at tiny sizes.  ``foreign_modules`` names the loaded modules of JAX, Flax
or the JAX package.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

#: top-level module names no run may hold (``repro`` is the JAX package;
#: the port's own name, ``repro_torch``, is another name)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules(names=None) -> list:
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FOREIGN)


def run_workload(root: Path, workload: str, seed: int, seconds: float,
                 trace: bool, device, t0: float) -> dict:
    """The result line of one run (the card is not checked here)."""
    from . import card, cells, checks
    cell = cells.cell(root, workload)
    ctx = types.SimpleNamespace(cell=cell, seed=int(seed),
                                seconds=float(seconds), trace=bool(trace),
                                device=device)
    out = cells.driver(cell).run(ctx)
    setup_s = out["window_start"] - t0
    metrics = {}
    if trace:
        run = types.SimpleNamespace(trace=out["trace"], work=out["work"],
                                    window=out.get("window"), cell=cell)
        for m in cell.per_layer:
            value = cells.reader(cell, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            # "<quantity>.<group>" is the driver's <quantity> under a
            # bound of its own for the cells it lists
            value = setup_s if m["name"] == "setup_s" else \
                out["e2e"].get(m["name"].split(".")[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, judged = checks.judge(out["numbers"], cell.limits)
    dev = card.describe(device, cell.chips)
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["trace"] is not None:
        dev["busy_s"] = out["trace"].busy_s()
        dev["window_s"] = out["trace"].window_s
        line["breakdown"] = out["trace"].breakdown()
    # the kernels' load, and whether this run built them (a checkout's
    # first run): inside setup_s, and recorded apart here
    line["setup_parts"] = out.get("setup_parts", {})
    line["readings"] = out.get("readings", {})
    line["checks"] = judged
    return line
