"""End to end: train a (reduced) LM with MemEC-style erasure-coded
in-memory checkpoints, lose a data-axis position, reconstruct it.

    PYTHONPATH=src python -m repro_torch.examples.train_ec_checkpoint \\
        [--arch starcoder2-3b] [--steps 120] [--device cpu]

The twin of the JAX package's ``examples/train_ec_checkpoint.py``: RS(3,2)
with 256-byte pages over a (4, 1) mesh (RS(10,8) on a real pod), the
parity updated from every step's old ⊕ new bytes (the paper's UPDATE),
then position 0 rebuilt from the others and compared with the live
state.  The mesh's four positions share one device (``launch/mesh.py``);
without ``--device`` it is the card.
"""
import argparse

import torch

from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ecstore import ECConfig
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models.convert import param_tree
from repro_torch.train.checkpoint import ECCheckpoint
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = dispatch.resolve_device(args.device)
    cfg = get_reduced(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    mesh = make_mesh((4, 1), ("data", "model"))
    params = param_tree(model)
    opt = make_optimizer("adamw", lr=1e-3, warmup_steps=10,
                         total_steps=args.steps)
    opt_state = opt.init(params)
    pspecs = shd.param_specs(cfg, params, mesh)
    # RS(3,2) over the 4-position data axis here; RS(10,8) on a real pod
    ec = ECCheckpoint(mesh, pspecs, ECConfig(k=2, m=1, page_size=256))
    step = make_train_step(model, opt, ec=ec)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8,
                                  embed_dim=cfg.d_model
                                  if cfg.input_mode == "embeddings" else 0,
                                  mrope=cfg.rope_kind == "mrope"),
                       device=dev)
    parity = ec.create(params)
    print("EC parity created:", tuple(parity.shape), parity.dtype)
    losses = []
    for i in range(args.steps):
        _, opt_state, parity, m = step(params, opt_state, data.batch(i))
        losses.append(float(m["loss"]))
        if i % 20 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    # --- failure drill: rebuild the shard from parity ---
    pages = ec.store.local_pages(params)
    rec = ec.reconstruct(params, failed_data_index=0)
    ok = bool(torch.equal(rec[0, 0], pages[0, 0]))
    print("reconstructed shard matches live state:", ok)
    assert ok
    return losses


if __name__ == "__main__":
    main()
