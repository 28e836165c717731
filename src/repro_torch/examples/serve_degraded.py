"""Serve a small model with batched requests; EC-protect the KV-cache
pages and demonstrate a degraded read (reconstruct lost cache pages).

    PYTHONPATH=src python -m repro_torch.examples.serve_degraded [--device cpu]

The twin of the JAX package's ``examples/serve_degraded.py``, on
recurrentgemma-2b's reduced config, as the reference's: a hybrid of
RG-LRU and local-attention layers, whose serving state is the attention
window's KV ring plus the recurrent states.  The cache is protected with
RS(3,2) over a (4, 1) mesh after the decode, and the pages of data
position 0 are rebuilt from the others.
"""
import argparse

import torch

from repro_torch.configs import get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ecstore import ECConfig
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = dispatch.resolve_device(args.device)
    cfg = get_reduced(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    B, prompt_len, gen_len = 4, 24, 24
    eng = ServeEngine(model, max_len=prompt_len + gen_len, batch_size=B,
                      device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, prompt_len),
                            generator=gen, device=dev)
    logits = eng.prefill({"tokens": prompts})
    print(f"prefilled {B}x{prompt_len} tokens")

    first = torch.argmax(logits, dim=-1)
    res = eng.decode(gen_len - 1, first_tokens=first)
    print("generated tokens (seq 0):", res.tokens[0][:12])

    # protect the serving state (KV window + recurrent states) with EC -
    # in production this runs continuously via delta parity updates
    # (refresh_cache_parity)
    mesh = make_mesh((4, 1), ("data", "model"))
    cspecs = shd.cache_specs(cfg, eng.cache_tree(), mesh)
    eng.protect_cache(mesh, cspecs, ECConfig(k=2, m=1, page_size=256))
    print("cache pages erasure-coded")

    # degraded read drill: rebuild cache pages of data-axis position 0
    pages = eng.ec_store.local_pages(eng.cache_tree())
    rec = eng.recover_cache_pages(0)
    ok = bool(torch.equal(rec[0, 0], pages[0, 0]))
    print("reconstructed cache pages match live cache:", ok,
          "(degraded GET at page granularity, paper §5.4)")
    assert ok
    return ok


if __name__ == "__main__":
    main()
