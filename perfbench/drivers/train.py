"""Driver of the training mixes: steps of ``make_train_step`` with AdamW
and an erasure-coded copy of the parameters kept fresh after each, closed
loop.

Set-up builds the one training object (model, optimizer state, EC copy,
step function) and drives it through the mix's ``first_steps`` on the
first batches, reading the program's loss at each, the first gradient
as the optimizer took it (its first moment over 1 - b1 after step 1) and
each parameter's change after them.  The window then calls the same step
on the next batches, each dispatched as soon as the last is issued, until
``seconds`` have passed, and waits for the card.  With ``trace``, the
window runs as in an untraced run, and after it one warm-up step and
``trace_steps`` more run under the profiler (AdamW's apply inside an
"optimizer" range, the EC copy's stage and commit inside "ec_stage" and
"ec_commit"); the trace is read and freed before the check.

After the window, the program's parity is compared byte for byte with
the reference's encode of the program's parameters; the program is freed;
the reference (``refmodel``) trains from the same weights and batches
through the same number of steps, and the gaps are compared.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import torch

from yardstick import card, checks, gfref, refmodel, traffic, weights, work
from yardstick.cells import load_module

common = load_module(Path(__file__).with_name("common.py"))

SPANS = ("optimizer", "ec_stage", "ec_commit")


def _moment_norms(params, m_tree, names: dict, b1: float) -> dict:
    """Each parameter's first moment over 1 - b1 (after one step: the
    gradient the optimizer took, clip included), as a norm, by name."""
    from repro_torch.tree import leaves, tensors
    out = {}
    for p, m in zip(leaves(params), leaves(m_tree)):
        for pt, mt in zip(tensors(p), tensors(m)):
            out[names[id(pt)]] = float(torch.linalg.vector_norm(
                mt.float())) / (1 - b1)
    return out


def _parity_wrong(named, specs, ec, A, code) -> int:
    """Parity bytes of the program's copy that differ from the
    reference's encode of the program's parameters."""
    k, m, page = code
    gamma = gfref.cauchy_parity(k + m, k)
    tensors = [(leaf.name, named[leaf.name]) for leaf in specs]
    pages = [gfref.position_pages(tensors, d, A, k, page) for d in range(A)]
    parity = ec.parity
    want_shape = (A, 1, m, pages[0].shape[0] // k, page)
    if tuple(parity.shape) != want_shape:
        return parity.numel() or 1
    wrong = 0
    for d in range(A):
        for r in range(m):
            ref = gfref.parity_row(pages, d, r, k, gamma)
            wrong += int((ref != parity[d, 0, r]).sum())
    return wrong


def _reference(conf, specs, seed, dev, batches, steps, quant=None) -> dict:
    """The reference's readings: each step's loss, the first clipped
    gradient's norm per leaf, each leaf's change after ``steps``."""
    ref = refmodel.Reference(conf, quant=quant)
    store = {leaf.name: torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
             for leaf in specs}
    weights.fill(store, specs, seed, dev)
    opt = refmodel.AdamW(conf["deployment"]["optimizer"])
    losses, grad1 = [], None
    for i in range(steps):
        loss, grads = ref.loss_and_grads(store, batches[i])
        seen = opt.step(store, grads)
        del grads
        losses.append(loss)
        grad1 = grad1 or seen
    change = {n: math.sqrt(v) for n, v in
              weights.change_sq(store, specs, seed, dev).items()}
    del store, opt
    card.free(dev)
    return {"losses": losses, "grad1": grad1, "change": change}


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers of a program's (or the control's) readings
    against the reference's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    grad, _ = checks.leaf_gap(prog["grad1"], ref["grad1"])
    change, _ = checks.leaf_gap(prog["change"], ref["change"],
                                checks.moving(ref["grad1"]))
    return {"loss_gap": loss, "grad_leaf_gap": grad,
            "change_leaf_gap": change}


def setup(ctx) -> dict:
    """The training object after its first steps, with the program's
    readings of them."""
    from repro_torch.models.convert import param_tree
    from repro_torch.train.train_step import make_train_step
    conf, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    hp = conf["deployment"]["optimizer"]
    cfg, model, named, specs = common.build_model(conf, ctx.seed, dev)
    card.log("weights drawn")
    params = param_tree(model)
    opt = common.optimizer(conf)
    if ctx.trace:
        opt = opt._replace(apply=common.spanned("optimizer", opt.apply))
    opt_state = opt.init(params)
    ec, A, code = common.ec_copy(conf, cfg, params)
    card.log("optimizer state and EC copy made")
    if ctx.trace:
        ec.stage = common.spanned("ec_stage", ec.stage)
        ec.commit = common.spanned("ec_commit", ec.commit)
    step = make_train_step(model, opt, ec=ec, grad_clip=hp["grad_clip"])
    batches = traffic.lm_batches(ctx.seed, mix["pool"], mix["batch"],
                                 mix["seq"], cfg.vocab_size, mix["zipf_a"],
                                 dev)
    ids = {id(t): n for n, t in named.items()}
    losses, grad1 = [], None
    for i in range(mix["first_steps"]):
        _, opt_state, _, metrics = step(params, opt_state, batches[i])
        losses.append(float(metrics["loss"]))
        card.log(f"step {i + 1}: loss {losses[-1]}")
        if i == 0:
            grad1 = _moment_norms(params, opt_state["m"], ids, hp["b1"])
    change = {n: math.sqrt(v) for n, v in
              weights.change_sq(named, specs, ctx.seed, dev).items()}
    card.sync(dev)
    card.log("first steps read")
    return dict(cfg=cfg, model=model, named=named, specs=specs,
                params=params, opt_state=opt_state, ec=ec, A=A, code=code,
                step=step, batches=batches,
                readings={"losses": losses, "grad1": grad1,
                          "change": change})


def run(ctx) -> dict:
    conf, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    parts = common.kernel_library(dev)
    st = setup(ctx)
    step, params, batches = st["step"], st["params"], st["batches"]
    opt_state = st["opt_state"]
    first, pool = mix["first_steps"], mix["pool"]
    B, S = mix["batch"], mix["seq"]
    n = 0
    window_start = time.perf_counter()
    while time.perf_counter() - window_start < ctx.seconds:
        step(params, opt_state, batches[(first + n) % pool])
        n += 1
    card.sync(dev)
    window_s = time.perf_counter() - window_start
    peak = card.peak_bytes(dev)
    card.log(f"window: {n} steps in {window_s:.3f} s, peak {peak} B")
    trace = None
    if ctx.trace:
        trace = common.profiled(
            dev, mix["trace_steps"],
            lambda i: step(params, opt_state,
                           batches[(first + n + 1 + i) % pool]), SPANS)
        card.log(f"traced: {trace.iters} steps in {trace.window_s:.3f} s")

    # the check: the parity, then the reference in the program's place
    del opt_state
    st["opt_state"] = None
    card.free(dev)
    numbers = {"parity_bytes_wrong": _parity_wrong(
        st["named"], st["specs"], st["ec"], st["A"], st["code"])}
    readings, specs = st["readings"], st["specs"]
    batches = batches[:first]
    del step, params
    common.free_all(dev, st)
    card.log(f"parity checked: {numbers['parity_bytes_wrong']} bytes off")
    ref = _reference(conf, specs, ctx.seed, dev, batches, first)
    card.log(f"reference: losses {ref['losses']}")
    numbers.update(gaps(readings, ref))

    s = refmodel.shapes(conf)
    k, m, page = conf["deployment"]["ec"]["k"], \
        conf["deployment"]["ec"]["m"], conf["deployment"]["ec"]["page_size"]
    A = dict(conf["deployment"]["mesh"])["data"]
    P = gfref.pages_per_position(specs, A, k, page)
    gamma = gfref.cauchy_parity(k + m, k)
    nnz = sum(1 for row in gamma for c in row if c)
    w = {"step_flops": work.train_step_flops(s, B, S),
         "kernel1_per_iter": work.matmul_work(m, k, nnz, A * P // k, page)}
    if s["layer_kind"] == "A":
        w["flash_call"] = work.flash_work(B, S, S, s["num_heads"],
                                          s["num_kv_heads"], s["head_dim"],
                                          True,
                                          refmodel.DTYPES[s["dtype"]].itemsize)
    return {"e2e": {"train_tokens_per_s": n * B * S / window_s},
            "attempted": n, "failed": 0, "window_start": window_start,
            "memory_peak_bytes": peak, "numbers": numbers,
            "readings": {"program": readings, "reference": ref},
            "trace": trace, "work": w, "window": (n, window_s),
            "setup_parts": parts}
