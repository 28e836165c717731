#!/usr/bin/env python3
"""Is the gap between kernel 11's training step and the plain attention's
bf16 rounding?  Step 1 of starcoder2-3b at full width, as chip_smoke's
train phase runs it (B 2 x S 2,048 from ``SyntheticLM(seed 0)``,
``remat="full"``), on several weight draws.

    python3 scripts/gnorm_draws.py [--seeds 0 1 2 3 4] [--out FILE]

For each seed it draws the bf16 weights (``Model.init`` from a
``torch.Generator`` on the card) and runs step 1 four ways: kernel 11
(its forward, the torch backward) and the plain attention under
autograd, each in bf16 and in a float32 twin of the same weights (the
bf16 values widened; kernel 11's fp32 body).  Per draw it prints the
loss and the gradient norm of each, and three gaps of each quantity:
kernel vs plain in bf16 (what chip_smoke bounds), kernel vs plain in
fp32, and plain bf16 vs plain fp32 (bf16 rounding of the whole step).
Gaps of the norm are relative, of the loss absolute, and of the
attention weight gradients (wq, wk, wv, wo) relative Frobenius, the
largest over the 30 layers.  If the fp32 pair agrees to ~1e-6 and the
bf16 pair sit about as far apart as bf16 plain from fp32 plain, the gap
is rounding.  The last line is a JSON object of every reading; with
``--out`` it is also written there.  Needs a card.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "starcoder2-3b"


def _gaps(cs, a, b) -> dict:
    """Gaps of a = (loss, norm, attn) against the reference b."""
    return {"loss": abs(a[0] - b[0]), "norm": abs(a[1] - b[1]) / b[1],
            "attn": cs.attn_grad_errors(a[2], b[2])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gnorm_draws: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import Model
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=cs.TRAIN_SEQ,
                                   global_batch=cs.TRAIN_BATCH, seed=0),
                        device=dev).batch(0)
    draws = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = Model(cfg, device=dev).init(gen)
        runs = {}
        for dtype in ("bf16", "fp32"):
            if dtype == "fp32":
                twin = cs.fp32_twin(torch, model)
                del model
                gc.collect()
                torch.cuda.empty_cache()
                model = twin
            runs[f"plain_{dtype}"] = cs.step1_grads(
                torch, model, batch, layers, "flash_attention",
                cs.plain_attention(fa))
            runs[f"kernel_{dtype}"] = cs.step1_grads(
                torch, model, batch, fa, "flash_attention_backward", None)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        draw = {"seed": seed,
                "loss": {k: v[0] for k, v in runs.items()},
                "norm": {k: v[1] for k, v in runs.items()},
                "kernel_vs_plain_bf16": _gaps(cs, runs["kernel_bf16"],
                                              runs["plain_bf16"]),
                "kernel_vs_plain_fp32": _gaps(cs, runs["kernel_fp32"],
                                              runs["plain_fp32"]),
                "plain_bf16_vs_fp32": _gaps(cs, runs["plain_bf16"],
                                            runs["plain_fp32"]),
                "kernel_bf16_vs_plain_fp32": _gaps(cs, runs["kernel_bf16"],
                                                   runs["plain_fp32"]),
                "seconds": time.perf_counter() - t0}
        del runs
        print(json.dumps(draw), flush=True)
        draws.append(draw)
    result = {"arch": ARCH, "batch": cs.TRAIN_BATCH, "seq": cs.TRAIN_SEQ,
              "card": cs.card_line(), "draws": draws}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
