"""Driver of the failure mixes: a data position of the erasure-coded copy
is lost and rebuilt, again and again, closed loop.

Set-up draws the configuration's parameters from the seed, makes the
deployment's optimizer state beside them (a trainer's card holds it
between steps; the rebuild does not read it), creates the copy's parity
(``ECCheckpoint.create``) and rebuilds every position once.
The window loses the position drawn for each iteration
(``traffic.positions``) and rebuilds it through
``ECCheckpoint.reconstruct``, waiting for each rebuild before the next
loss, until ``seconds`` have passed; each rebuild's time is taken by CUDA
events on the card.  The rebuilt pages of the iterations
``traffic.sample`` draws are kept (the program's own output, no copy).
With ``trace``, the window runs as in an untraced run, and after it one
warm-up rebuild and ``trace_iters`` more run under the profiler; the
trace is read and freed before the check.

After the window one more position, drawn from the seed, is lost for
real: the harness zeroes its blocks of every leaf that the mesh splits
(the replicated leaves stay on the survivors), and the program rebuilds
it.  The program is freed, and every kept rebuild is compared byte for
byte with the reference's pages of that position, laid out from the
weights drawn again from the seed (``gfref.position_pages``).
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import torch

from yardstick import card, gfref, traffic, weights, work
from yardstick.cells import load_module

common = load_module(Path(__file__).with_name("common.py"))

SPANS = ()


def p95(values: list) -> float:
    """The 95th percentile, nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def _wrong(out: torch.Tensor, want: torch.Tensor) -> int:
    if out.numel() != want.numel():
        return max(out.numel(), want.numel())
    return int((out.reshape(-1) != want.reshape(-1)).sum())


def run(ctx) -> dict:
    from repro_torch.models.convert import param_tree
    conf, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    parts = common.kernel_library(dev)
    cfg, model, named, specs = common.build_model(conf, ctx.seed, dev)
    params = param_tree(model)
    opt_state = common.optimizer(conf).init(params)
    ec, A, (k, m, page) = common.ec_copy(conf, cfg, params)
    card.log("weights drawn, optimizer state and parity made")
    for f in range(A):
        ec.reconstruct(params, f)
    card.sync(dev)
    card.log("every position rebuilt once")
    draws = traffic.positions(ctx.seed, mix["draws"], A)
    keep_at = set(traffic.sample(ctx.seed, mix["sample"],
                                 mix["sample_within"]))
    kept, lat = [], []
    watch = card.Stopwatch(dev)

    def rebuild(i: int) -> None:
        f = draws[i % len(draws)]
        watch.start()
        rec = ec.reconstruct(params, f)
        lat.append(watch.stop_ms())
        if i in keep_at:
            kept.append((f, rec.select(0, 0)))

    n = 0
    window_start = time.perf_counter()
    while time.perf_counter() - window_start < ctx.seconds:
        rebuild(n)
        n += 1
    card.sync(dev)
    window_s = time.perf_counter() - window_start
    peak = card.peak_bytes(dev)
    card.log(f"window: {n} rebuilds in {window_s:.3f} s, peak {peak} B")
    trace = None
    if ctx.trace:
        trace = common.profiled(
            dev, mix["trace_iters"],
            lambda i: ec.reconstruct(params, draws[-2 - i]), SPANS)
        card.log(f"traced: {trace.iters} rebuilds in {trace.window_s:.3f} s")

    # a real loss: the position's own blocks gone, then rebuilt
    lost = traffic.positions(ctx.seed + 1, 1, A)[0]
    with torch.no_grad():
        for leaf in specs:
            t = named[leaf.name]
            if gfref.is_split(t, leaf.name, A):
                gfref.block(t, leaf.name, lost, A).zero_()
    kept.append((lost, ec.reconstruct(params, lost).select(0, 0)))
    card.sync(dev)
    del model, params, ec, named, opt_state
    card.free(dev)

    store = {leaf.name: torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
             for leaf in specs}
    weights.fill(store, specs, ctx.seed, dev)
    tensors = [(leaf.name, store[leaf.name]) for leaf in specs]
    wrong = 0
    for f in sorted({f for f, _ in kept}):
        want = gfref.position_pages(tensors, f, A, k, page)
        wrong += sum(_wrong(out, want) for g, out in kept if g == f)
        del want
    compared = len(kept)
    card.log(f"{compared} rebuilds compared: {wrong} bytes off")
    del kept, store, tensors
    card.free(dev)

    P = gfref.pages_per_position(specs, A, k, page)
    nbytes, ops = work.matmul_work(1, k, k, P // k, page)
    return {"e2e": {"recover_ms": window_s * 1e3 / n,
                    "recover_ms_p95": p95(lat)},
            "attempted": n, "failed": 0, "window_start": window_start,
            "memory_peak_bytes": peak,
            "numbers": {"rebuilt_bytes_wrong": wrong},
            "readings": {"rebuilds_compared": compared},
            "trace": trace, "window": (n, window_s), "setup_parts": parts,
            "work": {"kernel1_per_iter": (k * nbytes, k * ops),
                     "iter_bytes": k * nbytes}}
