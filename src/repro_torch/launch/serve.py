"""Serving launcher: batched greedy (or sampled) generation with random
weights, on the card unless asked for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --reduced --device cpu

``--arch`` takes any of the ten names (``configs.ARCH_NAMES``).  Prompts
are token ids for every arch, as in the reference's launcher (an
embeddings config embeds them through its table).

Weights and prompts are drawn from ``--seed`` by a ``torch.Generator`` on
the device.  The times are host-clock seconds around work that ends in a
device synchronise.

``--protect`` erasure-codes the cache pages after the prefill (every
layer's serving state: KV, a local layer's ring, MLA latents, recurrent
states), as the
reference does (the 1 x 1 host mesh, ``sharding.cache_specs``,
``ECConfig(k=1, m=1, page_size=256)``), folds the decode's cache writes
into the parity when the decode ends (``refresh_cache_parity``), and
rebuilds the pages of data position 0 from the parity
(``recover_cache_pages``), printing whether they equal the live cache
pages byte for byte.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_reduced
from ..distributed import sharding as shd
from ..distributed.ecstore import ECConfig
from ..kernels import dispatch
from ..models import Model
from ..models import layers
from ..serve.engine import ServeEngine
from .mesh import make_host_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--protect", action="store_true",
                    help="EC-protect the KV cache pages")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = dispatch.resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = Model(cfg, device=dev).init(gen)
    eng = ServeEngine(model, max_len=args.prompt_len + args.gen,
                      batch_size=args.batch, device=dev, generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"{cfg.name} ({'reduced' if args.reduced else 'full width'}, "
          f"{cfg.num_layers} layers, {cfg.dtype}) on {name}")

    layers.reset_op_paths()
    _sync(dev)
    t0 = time.perf_counter()
    logits = eng.prefill({"tokens": prompts})
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    if args.protect:
        mesh = make_host_mesh()
        cspecs = shd.cache_specs(cfg, eng.cache_tree(), mesh)
        eng.protect_cache(mesh, cspecs, ECConfig(k=1, m=1, page_size=256))
        protected = eng.cache_snapshot()
        print("cache pages EC-protected")
    first = torch.argmax(logits, dim=-1)
    t0 = time.perf_counter()
    res = eng.decode(args.gen, temperature=args.temperature,
                     first_tokens=first)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    print(f"prefill {args.batch}x{args.prompt_len} in {t_prefill:.2f}s; "
          f"decoded {args.gen} steps in {t_decode:.2f}s "
          f"({args.batch * args.gen / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample tokens:", res.tokens[0][:16])
    print("attention routes:", dict(sorted(layers.OP_PATHS.items())))
    if args.protect:
        eng.refresh_cache_parity(protected)
        rec = eng.recover_cache_pages(0)
        live = eng.ec_store.local_pages(eng.cache_tree())
        print(f"recovered cache pages of data position 0 ({rec.shape[-2]} "
              f"pages of {rec.shape[-1]} B) equal the live cache: "
              f"{bool(torch.equal(rec[0], live[0]))}")
    return res


if __name__ == "__main__":
    main()
