"""Training launcher: trains end to end with EC in-memory checkpoints, on
the card unless asked for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --reduced --steps 200 --batch 8 --seq 128 --ec
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --reduced --steps 20 --ec --device cpu

The port of the JAX package's ``launch/train.py``, with its flags and
output, plus ``--device``.  Weights are drawn from ``--seed`` by a
``torch.Generator`` on the device (other numbers than the reference's for
the same seed); ``--ckpt-dir`` resumes from the latest disk checkpoint
there, the reference's or the port's.  ``--ec`` keeps an RS(k+m, k)
in-memory copy of the parameters over the 1 x 1 host mesh, updated
after every step.

``--mesh single|multi`` trains over the production mesh (16 x 16, or
2 x 16 x 16 with pods) with one rank a position, when the process is one
rank of a ``torch.distributed`` world of that many (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address from the
environment, as ``torchrun`` sets them):

    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch starcoder2-3b --mesh single --ec

Each rank draws its blocks of the seed's weights (``ranked.init_blocks``)
and runs ``train_on_rank``: NCCL where every local rank has a card of
its own, gloo otherwise.  Started any other way, ``--mesh single|multi``
refuses, naming the devices the mesh needs.  ``train_on_rank`` is the
same training on a rank of any mesh, for callers that start the ranks
themselves (``distributed.ranks.launch``).
"""
from __future__ import annotations

import argparse
import functools
import os
import time

import torch
import torch.distributed as dist

from ..configs import get_config, get_reduced
from ..data.pipeline import DataConfig, SyntheticLM
from ..distributed import sharding as shd
from ..distributed import ranks
from ..distributed.ecstore import ECConfig
from ..kernels import dispatch
from ..models import Model, layers
from ..models.convert import param_tree
from ..models.ranked import RankModel, init_blocks
from ..train import checkpoint as ckpt
from ..train.optimizer import OPTIMIZERS, Blocks, Optimizer, make_optimizer
from ..train.train_step import make_rank_train_step, make_train_step
from .dryrun import _opt_specs
from .mesh import make_host_mesh, make_production_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ec", action="store_true",
                    help="maintain an EC in-memory checkpoint")
    ap.add_argument("--ec-k", type=int, default=2)
    ap.add_argument("--ec-m", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "host":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
        if int(os.environ.get("WORLD_SIZE", "0") or 0) != mesh.size:
            ap.error(f"--mesh {args.mesh} is the production mesh "
                     f"{mesh.shape} ({mesh.size} devices); run it as "
                     f"{mesh.size} torch.distributed ranks (torchrun), or "
                     f"use --mesh host on one card")
        return _main_rank(args, mesh)

    dev = dispatch.resolve_device(args.device)
    cfg = (get_reduced(args.arch) if args.reduced else get_config(args.arch))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = Model(cfg, device=dev).init(gen)
    mesh = make_host_mesh()
    params = param_tree(model)
    opt = make_optimizer(args.optimizer, lr=args.lr,
                         warmup_steps=min(20, args.steps // 5 + 1),
                         total_steps=args.steps)
    opt_state = opt.init(params)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0,
        mrope=cfg.rope_kind == "mrope"), device=dev)

    start_step = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            ckpt.restore_checkpoint(args.ckpt_dir, last,
                                    {"p": params, "o": opt_state})
            start_step = last
            print(f"resumed from step {last}")

    ec = None
    if args.ec:
        pspecs = shd.param_specs(cfg, params, mesh)
        ec_cfg = ECConfig(k=args.ec_k, m=args.ec_m, page_size=256,
                          axis="data")
        ec = ckpt.ECCheckpoint(mesh, pspecs, ec_cfg)
        ec.create(params)
        print(f"EC checkpoint created: RS({ec_cfg.n},{ec_cfg.k}), "
              f"overhead {ec_cfg.m}/{ec_cfg.k}")

    step_fn = make_train_step(model, opt, ec=ec)
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        out = step_fn(params, opt_state, data.batch(step))
        metrics = out[-1]
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({dt:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, step + 1,
                                 {"p": params, "o": opt_state})
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


def _main_rank(args, mesh):
    """``--mesh single|multi`` as one rank of the world the environment
    names (module notes)."""
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    own_card = (args.device in (None, "cuda") and torch.cuda.is_available()
                and torch.cuda.device_count() >= per_host)
    if own_card:
        torch.cuda.set_device(local)
    dev = dispatch.resolve_device(f"cuda:{local}" if own_card
                                  else args.device)
    dist.init_process_group("nccl" if own_card else "gloo",
                            init_method="env://", rank=rank,
                            world_size=mesh.size)
    try:
        cfg = (get_reduced(args.arch) if args.reduced
               else get_config(args.arch))
        comm = ranks.RankComm(mesh)
        return train_on_rank(
            comm, cfg, steps=args.steps, batch=args.batch, seq=args.seq,
            optimizer=args.optimizer, lr=args.lr, ec=args.ec,
            ec_k=args.ec_k, ec_m=args.ec_m, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, log_every=args.log_every,
            seed=args.seed, device=dev,
            log=functools.partial(print, flush=True) if rank == 0
            else (lambda *a: None))
    finally:
        dist.destroy_process_group()


def state_specs_of(opt: Optimizer, model: RankModel) -> dict:
    """The partition specs of ``opt``'s state of ``model``'s parameters:
    the reference's ``_opt_specs`` of the whole state's shapes (AdamW's
    moments as their parameters, adamw8bit's and adafactor's state
    replicated)."""
    with dispatch.dry_run():
        whole = opt.init(param_tree(Model(model.cfg, device="meta")))
    return _opt_specs(whole, model.specs, model.mesh)


def train_on_rank(comm, cfg, params=None, *, steps: int = 100,
                  batch: int = 8, seq: int = 128, optimizer="adamw",
                  lr: float = 1e-3, ec: bool = False, ec_k: int = 2,
                  ec_m: int = 1, ckpt_dir=None, ckpt_every: int = 50,
                  log_every: int = 10, seed: int = 0, device=None,
                  observe=None, log=print) -> list:
    """Train ``cfg`` on this rank of its mesh, as ``main`` trains on one
    card, and return the losses.  ``comm``: the rank's data-axis
    ``ranks.RankComm`` (``ranks.launch`` passes it) or its
    ``ranks.AxisComms``; ``params``: the rank's own blocks (trained in
    place), or None to draw the seed's (``ranked.init_blocks``) on
    ``device``; ``optimizer``: a name or an ``Optimizer`` (adamw,
    adamw8bit or adafactor, its state placed as the reference's
    ``_opt_specs`` places it).  The flags are ``main``'s; ``ckpt_dir``
    resumes from and writes disk checkpoints in the reference's format
    (whole leaves; a replicated state written once), restored before the
    EC copy is created.
    ``observe(step, state)``, if given, is called after each step with
    {"model", "params", "opt_state", "ec", "metrics"}."""
    comms = comm if isinstance(comm, ranks.AxisComms) else \
        ranks.rank_comms(comm)
    mesh, coords = comms.mesh, comms.coords
    if params is None:
        dev = dispatch.resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_blocks(cfg, mesh, coords, gen)
    layers.set_activation_mesh(comms)
    try:
        model = RankModel(cfg, params, comms)
        params = model.params
        dev = model.device
        opt = optimizer if isinstance(optimizer, Optimizer) else \
            make_optimizer(optimizer, lr=lr,
                           warmup_steps=min(20, steps // 5 + 1),
                           total_steps=steps)
        opt_state = opt.init(params, place=Blocks(model.specs, comms))
        data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            seed=seed,
            embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0,
            mrope=cfg.rope_kind == "mrope"), device=dev)
        state_specs = {"p": model.specs, "o": state_specs_of(opt, model)}
        start_step = 0
        if ckpt_dir:
            last = ckpt.latest_step(ckpt_dir)
            if last is not None:
                ckpt.restore_checkpoint(ckpt_dir, last,
                                        {"p": params, "o": opt_state},
                                        specs=state_specs, mesh=mesh,
                                        coords=coords)
                start_step = last
                log(f"resumed from step {last}")
        ec_ckpt = None
        if ec:
            ec_cfg = ECConfig(k=ec_k, m=ec_m, page_size=256, axis="data")
            ec_ckpt = ckpt.ECCheckpoint(mesh, model.specs, ec_cfg,
                                        comms.data)
            ec_ckpt.create(params)
            log(f"EC checkpoint created: RS({ec_cfg.n},{ec_cfg.k}), "
                f"overhead {ec_cfg.m}/{ec_cfg.k}")
        step_fn = make_rank_train_step(model, opt, ec=ec_ckpt)
        losses = []
        t0 = time.time()
        for step in range(start_step, steps):
            out = step_fn(params, opt_state, data.batch(step))
            opt_state, metrics = out[1], out[-1]
            losses.append(float(metrics["loss"]))
            if observe is not None:
                observe(step, {"model": model, "params": params,
                               "opt_state": opt_state, "ec": ec_ckpt,
                               "metrics": metrics})
            if step % log_every == 0 or step == steps - 1:
                log(f"step {step:5d}  loss {losses[-1]:.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.3f}  "
                    f"({time.time() - t0:.1f}s)")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt.save_checkpoint(ckpt_dir, step + 1,
                                     {"p": params, "o": opt_state},
                                     specs=state_specs, comms=comms)
        if losses:
            log(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
        return losses
    finally:
        layers.set_activation_mesh(None)


if __name__ == "__main__":
    main()
