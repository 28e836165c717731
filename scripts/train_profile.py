#!/usr/bin/env python3
"""Where a training step's time goes on the card: starcoder2-3b (or
``--arch``) at full width (or ``--reduced``), B x S tokens from
``SyntheticLM``, AdamW as ``launch.train`` sets it and an RS(3,2)
``ECCheckpoint`` over a (data 4, model 1) mesh, as chip_smoke's train
phases run them.

    python3 scripts/train_profile.py [--arch A] [--reduced] [--batch 2] [--seq 2048]

After ``--warm`` steps it runs ``--steps`` steps of ``make_train_step``
untraced and ``--steps`` more under ``torch.profiler`` (CUDA activity),
and prints, per step, the untraced host wall time, the traced device's
busy time (the union of its kernel, copy and set intervals), the idle
share of the first in the second, the sum of the kernels' times, and the
device time of the kernels launched inside a few functions, each wrapped
in a ``record_function`` range: kernel 11's forward calls (forward and remat
recompute), the attention backward ``flash_attention_backward``, the
gradient norm, and the EC stage (old bytes) and commit (new bytes,
rotate, kernel 1, fold).  Each part is read two ways.
``parts_span_s`` is the union of the kernels inside the range's span on
the device timeline (one stream, so the kernels the range launched).
``parts_device_s`` is the profiler's ``device_time_total`` of the range,
the kernels matched to its host calls by launch correlation; it misses
the kernels the port's ctypes wrappers launch (kernel 11 reads 0) and
can count a kernel more than once (the EC commit reads twice its span),
so read the span.  A range opened on one thread sees nothing launched
from another: the backward's kernels come from autograd's thread, so no
range opened around ``loss.backward()`` holds them.  Then it runs
``--steps`` more steps as ``make_train_step``'s parts one by one with a
synchronize between them (forward, backward, norm, optimizer, EC stage
and commit) and prints each part's seconds per step.  The last line is a JSON object of those numbers.  Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PARTS = {  # range name -> (module, attribute) wrapped in it
    "attention_backward": ("repro_torch.kernels.flash_attention",
                           "flash_attention_backward"),
    "attention_forward": ("repro_torch.kernels.flash_attention",
                          "_flash_forward"),
    "grad_norm": ("repro_torch.train.train_step", "global_norm"),
    "ec_stage": ("repro_torch.train.checkpoint.ECCheckpoint", "stage"),
    "ec_commit": ("repro_torch.train.checkpoint.ECCheckpoint", "commit"),
}


def _wrap(torch, name, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def _install(torch) -> None:
    for name, (mod, attr) in PARTS.items():
        if mod.endswith(".ECCheckpoint"):
            owner = getattr(importlib.import_module(mod.rsplit(".", 1)[0]),
                            "ECCheckpoint")
        else:
            owner = importlib.import_module(mod)
        setattr(owner, attr, _wrap(torch, name, getattr(owner, attr)))


def _busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _install(torch)
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.ecstore import ECConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.convert import param_tree
    from repro_torch.train.checkpoint import ECCheckpoint
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.optimizer import clip_scale, global_norm
    from repro_torch.train.train_step import make_loss_fn, make_train_step
    from repro_torch.tree import map_parts, tree_map

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    params = param_tree(model)
    total = args.warm + args.steps
    # the schedule spans the untraced, traced and timed-apart steps
    opt = make_optimizer("adamw", lr=1e-3,
                         warmup_steps=min(20, total // 5 + 1),
                         total_steps=total + 2 * args.steps)
    opt_state = opt.init(params)
    mesh = make_mesh((4, 1), ("data", "model"))
    ec = ECCheckpoint(mesh, shd.param_specs(cfg, params, mesh),
                      ECConfig(k=2, m=1, page_size=256))
    ec.create(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch),
                       device=dev)
    step = make_train_step(model, opt, ec=ec)
    for i in range(args.warm):
        step(params, opt_state, data.batch(i))
    torch.cuda.synchronize()
    batches = [data.batch(args.warm + i) for i in range(2 * args.steps)]
    t0 = time.perf_counter()
    for b in batches[:args.steps]:
        out = step(params, opt_state, b)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[args.steps:]:
            out = step(params, opt_state, b)
        torch.cuda.synchronize()
    loss = float(out[-1]["loss"])
    events = prof.events()
    device_events = [ev for ev in events
                     if ev.device_type == DeviceType.CUDA]
    # the ranges' device-timeline annotations, spanning their kernels
    spans = [ev for ev in device_events if ev.name in PARTS]
    device = [(ev.time_range.start, ev.time_range.end)
              for ev in device_events if ev.name not in PARTS]
    busy = _busy_us(device) / 1e6 / args.steps
    kernels = sum(e - s for s, e in device) / 1e6 / args.steps
    parts = dict.fromkeys(PARTS, 0.0)
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.name in PARTS:
            parts[ev.name] += ev.device_time_total / 1e6 / args.steps
    parts_span = dict.fromkeys(PARTS, 0.0)
    for sp in spans:
        lo, hi = sp.time_range.start, sp.time_range.end
        parts_span[sp.name] += _busy_us(
            (s, e) for s, e in device if s >= lo and e <= hi) \
            / 1e6 / args.steps

    # make_train_step's parts one by one, a synchronize between them
    loss_fn = make_loss_fn(model)
    apart = {k: [] for k in ("forward", "backward", "grad_norm", "ec_stage",
                             "optimizer", "ec_commit")}
    for i in range(args.steps):
        b = data.batch(total + args.steps + i)
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        for t in model.parameters():
            t.grad = None
        loss_t, _ = loss_fn(params, b)
        mark()
        loss_t.backward()
        mark()
        with torch.no_grad():
            grads = tree_map(lambda p: map_parts(lambda t: t.grad, p),
                             params)
            scale = clip_scale(global_norm(grads), 1.0)
            mark()
            ec.stage(params)
            mark()
            opt.apply(grads, opt_state, params, scale)
            del grads
            for t in model.parameters():
                t.grad = None
            mark()
            ec.commit(params)
            mark()
        for key, t0, t1 in zip(apart, marks, marks[1:]):
            apart[key].append(t1 - t0)
    result = dict(card=card, arch=cfg.name, width="reduced" if args.reduced
                  else "full", batch=args.batch, seq=args.seq,
                  tokens=args.batch * args.seq, step_wall_s=wall,
                  device_busy_s=busy, idle_share=1 - busy / wall,
                  kernel_sum_s=kernels, parts_device_s=parts,
                  parts_span_s=parts_span, parts_apart_s=apart, loss=loss)
    for k, v in parts.items():
        print(f"{k}: {v:.4f} s of device time a step (span: "
              f"{parts_span[k]:.4f})", flush=True)
    for k, v in apart.items():
        print(f"{k}: {', '.join(f'{x:.4f}' for x in v)} s, timed apart",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
