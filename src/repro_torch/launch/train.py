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
after every step.  Only ``--mesh host`` runs: the production meshes need
16 x 16 or 2 x 16 x 16 devices, and the port runs one card.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_reduced
from ..data.pipeline import DataConfig, SyntheticLM
from ..distributed import sharding as shd
from ..distributed.ecstore import ECConfig
from ..kernels import dispatch
from ..models import Model
from ..models.convert import param_tree
from ..train import checkpoint as ckpt
from ..train.optimizer import make_optimizer
from ..train.train_step import make_train_step
from .mesh import make_host_mesh, make_production_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adamw")
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
        ap.error(f"--mesh {args.mesh} is the production mesh "
                 f"{mesh.shape} ({mesh.size} devices); this port runs one "
                 f"card: use --mesh host")

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


if __name__ == "__main__":
    main()
