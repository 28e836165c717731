#!/usr/bin/env python3
"""Drive the PyTorch port of MemEC on one CUDA card and check every result.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing runs on the CPU
in place of the card):

1. device  - needs ``torch.cuda``; prints the card's name and power limit
             and the torch/CUDA versions;
2. build   - compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc,
             then reads the library's SASS (``cuobjdump -sass``): every
             instantiation of the bf16 flash body (hd 16, 32, 64, 112,
             128, 256) must hold HGMMA (wgmma) and UTMALDG (TMA loads),
             and the counts are printed;
3. kernels - each of the eleven hand-written kernels against its plain
             torch version on the card: the ten GF(2^8) and probe kernels
             byte-exact, the batched ones at B = 1, 64, 4096 and C = 4096,
             1000 (and C = 256, RDP's sub-block row, for the RDP shapes;
             kernel 3 also at B = 36, on the RDP encode and its two- and
             one-chunk decodes), the single-stripe ones at C = 4096, 1000
             and 1 MiB (kernel 9 also at m = 4 and with 0/1 gammas), the probe
             at Q = 1, 64, 65,536 on a 2^20-bucket table; flash attention
             within its stated tolerance on the reference test's grid in
             fp32 and bf16, non-causal at S = 128 and 100, and the
             starcoder2-3b prefill shape; at hd 112 and 256 in both dtypes,
             causal and not, with ragged Skv, and at the recurrentgemma-2b
             (B 4, S 2,048, H 10, KV 1, hd 256) and kimi-k2 (B 1, S 2,048,
             H 64, KV 8, hd 112) prefill shapes, where it is also timed;
             a kernel faulted in its last Q tile must miss the tolerance
             at both new head dims; kernels 4-7 (coefficients in
             the launch parameters) also in their other coefficient form
             (0/1 masks or general bytes) and at a batch that splits
             into several launches; the timed calls of kernels 1-9
             (coefficients, or for 1, 2 and 8 the shared matrix's nibble
             tables and for 3 its row masks, in the launch parameters)
             must show no host-to-device copy in the trace and raise
             nothing under sync-debug mode "error"; at the widths the
             main path gives each kernel: CUDA-event time of a wrapper
             call, the
             kernel's own device time per call from a ``torch.profiler``
             trace, the plain version's time, for attention the time of
             ``scaled_dot_product_attention`` (a yardstick the port never
             calls) and the achieved TFLOP/s (bf16 at the prefill shape
             and at B 1, S 256; fp32 at the prefill shape), and the bound
             from these inputs' bytes and operations; then the
             engine-level host time of an RS sealed-update batch, of the
             RS and RDP seal folds and of an RS encode and fused decode
             (B = 64) on the CUDA and numpy engines;
4. RS      - the paper's testbed (``configs/memec.py``: 16 servers,
             4 proxies, RS(10,8), c = 16, 4 KB chunks) on
             ``engine="cuda"``, YCSB batch 64: load, workload A, a
             data-server fail/restore, a parity-server fail/restore with
             A and D, against a twin on the numpy engine (run at the
             same time in a spawned process of its own).  Contents,
             ``stats`` and the transitions must be equal, the parity sweep
             must find no stale parity, and the RS kernels must have
             launched.  The decodes of each ``fail_server`` are then
             replayed on the numpy, plain-torch and CUDA engines and
             timed;
5. RDP     - the same scenario with ``scheme="rdp"`` (RDP(10,8), p = 17,
             sixteen 256-byte sub-blocks per chunk): the 0/1 kernel, the
             per-item kernel and the per-item fold must have launched;
6. RS(14,10) - one ``CudaEngine`` decode of 200 stripes whose patterns
             re-encode three or four parities, against ``NumpyEngine``:
             the column-loop kernel must have launched;
7. ops     - ``repro_torch.kernels.ops`` on RS(10,8) 4 KB chunks (encode,
             decode of two lost positions, a parity delta, an index
             probe) against ``core.codes`` and the index, then
             ``repro_torch.quickstart`` on the card: kernels 8-10 (the
             single-stripe product, the fused old/new delta, the cuckoo
             probe) must have launched;
8. sharded - ``configs/memec.py`` with ``shards=4, placement="ring"``:
             four paper testbeds as the shards of one cluster, sharing
             the card, on ``engine="cuda"`` against a numpy twin (in a
             process of its own, at the same time) - load,
             A, a data-server fail/restore in one shard with A running,
             ``add_shard`` (live migration) and ``rebalance``.  Contents,
             ``stats`` and reports must be equal, every shard's parity
             sweep must find no stale parity, and the seal, delta and
             decode kernels must have launched;
9. model   - starcoder2-3b at full width (30 layers, d_model 3072, bf16,
             random weights from a seeded generator): ``Model.apply`` on
             4 x 2,048 tokens must launch the flash kernel once per layer
             and nothing else, held against an fp32 twin of the same
             weights (whose ``apply`` runs the fp32 kernel at full length)
             within the fixed ``BF16_LOGIT_TOL`` = 0.75; ``decode_step``
             over the first 128 positions must match the prefill logits
             (the twin's within ``FP32_LOGIT_TOL`` = 1e-3; in bf16 within
             0.75, against the bf16 prefill and the twin's decode); a
             control, kernel 11 faulted in its last Q tile, must read
             above 0.75 against the twin; then
             ``repro_torch.launch.serve --protect`` at its defaults (4 x
             32 prompt tokens, 32 generated; the KV cache pages
             erasure-coded over the 1 x 1 host mesh, RS(2,1)): the pages
             of data position 0 rebuilt by ``recover_cache_pages(0)``
             must equal the live cache pages byte for byte;
10. hybrid - recurrentgemma-2b at full width (26 layers, 8 x "RRW" +
             "RR", d_model 2,560, 10 / 1 heads of 256, window 2,048, bf16):
             ``Model.apply`` on 4 x 2,048 tokens launches kernel 11 once
             per W layer (8, at hd 256) and nothing else, against an fp32
             twin within 0.75, each kernel-11 call against its plain
             version within its tolerance, where the faulted control
             must fail; ``Model.apply``
             on 2 x 4,096 tokens takes the windowed torch route in every
             W layer and launches nothing; ``decode_step`` over 128
             positions against the prefill; ``launch.serve --arch
             recurrentgemma-2b --protect`` rebuilds the pages of the W
             ring and the RG-LRU states byte for byte (kernel 1);
11. families - qwen2-vl-7b, musicgen-medium (embedding inputs),
             minicpm3-4b (MLA), mamba2-370m at 2 layers,
             llama4-maverick-400b-a17b and kimi-k2-1t-a32b (MoE; kernel
             11 at hd 112) at 1 layer, all at full width: one prefill and
             8 decode steps each against it (4 for the MoE configs, whose
             4-token rows cannot overflow an expert), kernel 11 once per attention
             layer and each call within its tolerance of the plain
             version, no dropped MoE assignment; each model freed before
             the next;
12. train  - starcoder2-3b at full width, ``remat="full"``, B 2 x S 2,048
             from ``SyntheticLM(seed 0)``, AdamW as ``launch.train`` sets
             it, four steps, an ``ECCheckpoint`` RS(3,2) with 256-byte
             pages over a (data 4, model 1) mesh updated after every step
             (old ⊕ new through kernel 1): step 1's loss and gradient
             norm, and each layer's attention weight gradients, against
             the same step with the plain attention: the loss within
             ``TRAIN_LOSS_TOL``, the norm and gradients within bounds
             derived in the same run from an fp32 twin of the weights
             (``TWIN_MULTIPLE`` times the plain step's bf16-vs-fp32 gap;
             a control whose backward sums dK over the first query tile
             alone must miss them); after the last step the parity
             equals a fresh encode byte for byte, every data position
             rebuilds byte for byte, and a flipped parity byte must break
             the rebuild of a position it protects; every loss finite;
             then ``launch.train --reduced --steps 20 --ec`` on the card,
             whose loss must fall.  Kernel 11 (forward and remat
             recompute) and kernel 1 must launch; kernel 1 is then held
             against its plain version at the EC update's shape.  Prints
             loss, seconds and tokens/s per step, peak GB and the EC
             encode, update and reconstruct ms;
13. train-hybrid - recurrentgemma-2b at full width and full depth (26
             layers, 2.78e9 parameters, hd 256, window 2,048, vocab
             256,000), trained as phase 12 (three steps, the same EC
             copy and checks, step 1 over the 8 W layers' attention
             weights), and each kernel-11 call of step 1's forward held
             against the plain version, where the faulted control must
             fail: kernel 11 launches twice per W layer a step;
14. train-families - qwen2-vl-7b (M-RoPE, embeddings), musicgen-medium
             (embeddings), minicpm3-4b (MLA) at 2 layers and B 2 x S 256,
             mamba2-370m at its full 48 layers and B 2 x S 2,048, full
             width: step 1's bf16 loss and norm against an fp32 twin of
             the same weights, and every parameter's gradient tensor by
             tensor (``FAMILY_LOSS_TOL``, ``FAMILY_NORM_TOL``,
             ``family_leaf_bound``; Mamba-2 with its last SSD chunk's
             gradient dropped must miss the last), then one timed AdamW
             step with kernel 11 twice per attention layer;
15. train-moe - llama4-maverick-400b-a17b and kimi-k2-1t-a32b at their
             reduced configs (a full-width layer's weights alone take
             41-44 GB) in fp32: one AdamW step on the card against the
             same step on the CPU - loss, norm and every gradient leaf
             within 1e-5, the parameters after within 5e-5, the routing
             and the dropped assignments equal;
16. tune   - the shape tuner (``kernels/tune.py``) on the card at the
             reference's CI shapes into a temporary cache named by
             ``$MEMEC_TORCH_TUNE_CACHE``: every candidate byte-equal to
             the plain version, each shape's winner printed with its µs
             beside the µs of the body the built-in rule picks; with
             that cache one call per shape launches the winner's kernel
             (a per-item shape in the winner's coefficient form), with
             the committed defaults (no ``cuda-kernel`` entry) today's;
17. ranks  - the EC store with one mesh position per rank
             (``distributed/ranks.py``): ranks spawned with
             ``torch.multiprocessing`` on this card under gloo (NCCL
             refuses two ranks on one card), initialised through a
             ``file://`` store, joined within a deadline.  (a)
             starcoder2-3b's parameters at full width and depth laid out
             over (data 4, model 1), RS(3,2) with 256-byte pages: each
             rank gets its blocks of the parent's parameters (shared, not
             copied) and runs ``ECCheckpoint(comm=...)``: ``create``, a
             ``stage``/``commit`` around a seeded in-place change, and the
             rebuild of data index 0; (b) RS(10,8) with 4 KB pages over
             (12, 1) on 64 MiB of seeded pages a rank: encode, the delta
             update, the systolic chain, the pair rebuild of (0, 5) both
             ways.  Each result equals the stacked store's, computed
             first on the card, byte for byte; each rank sends m*k*S
             pages an update and (A - 1)*k*S a rebuild, launches kernel
             1 and takes no CPU or plain path; prints per rank the
             seconds and bytes of each operation, its launches and
             ``op_paths``;
18. model-ranks - starcoder2-3b at full width, 4 of its 30 layers, bf16, over
             (data 2, model 2): four gloo ranks on this card, each holding
             its blocks of the parent's one-card model (shared, not
             copied) and running ``models/ranked.py``'s ``RankModel``:
             a prefill of 2 x 2,048 and 4 decode steps (teacher-forced
             with the one-card model's tokens, a cache of 4 positions
             split 2 + 2 over "model") with ``attn_parallel="seq"`` (8
             steps until the serve-ranks phase took their time; a "head"
             pass until phase 23's kimi-k2 layer took the "head" path
             over).  Each rank's logits
             block must stay within ``MODEL_RANKS_TWIN_MULTIPLE`` (2)
             times the one-card bf16 logits' distance from an fp32 twin,
             measured in the run, of the one-card model's; kernel 11
             launches once a layer a prefill on every rank and every
             rank's ``op_paths`` show ``cuda-kernel`` only.  Before the
             spawn, kernel 11 on a stripe (``flash_attention(stripe=)``)
             is held against the plain version with the same stripe at
             the rank shape (1,024 query rows, two 512-row segments, on
             2,048 keys) and at a ragged S of 1,500 (the second stripe's
             last 548 rows past the keys), a launch with the wrong stripe index must miss the bound,
             and the stripe launch is timed beside the plain version and
             ``scaled_dot_product_attention`` with the stripe's mask (its
             device time from a profiler trace and from the replay of a
             CUDA graph of 20 launches, ``graph_device_ms``).
             Prints per rank its bytes sent by kind, the seconds of a
             prefill and of a decode step, and its peak GB;
19. serve-ranks - ``ServeEngine`` on ``RankModel``s over (data 2,
             model 2), four gloo ranks on this card, each holding its
             blocks of the parent's one-card model: (a) qwen2-vl-7b at
             full width (M-RoPE, an embeddings input, bf16), depth cut to
             2 of 28 layers (every decode step gathers every layer again
             over gloo): ``apply`` on 2 x 2,048 embeddings with three
             M-RoPE position streams, each rank's logits block within
             ``MODEL_RANKS_TWIN_MULTIPLE`` times the one-card bf16
             logits' distance from an fp32 twin and its bytes by kind
             equal to ``dryrun.count_rank_forward``'s; a 4-token prefill
             token by token, ``protect_cache`` (RS(1,1) over "data",
             256-byte pages: ``launch.serve``'s defaults), 8 decode
             steps at temperature 1.0, ``refresh_cache_parity`` and
             ``recover_cache_pages(0)`` on every rank: the pages equal
             the stacked one-card store's over the cache gathered from
             the ranks, the parity a fresh encode, the rebuild the live
             pages, byte for byte, and a flipped parity byte must change
             the rebuild; the rank sampler on the one-card model's last
             logits, split into each rank's block, draws the one-card
             sampler's tokens on every rank, and the share of sampled
             tokens equal to the one-card engine's is printed; (b) the
             attention options at starcoder2-3b's widths (layers "AW",
             a 1,024-slot window, the int8 KV cache, softcaps 50 and 30,
             2 layers): a prefill of 2 x 2,048 (the masked stripes) and 8
             greedy decode steps over the int8 ring, within the same
             twin-based bounds.  Kernels 11 and 1 must launch on every
             rank, ``op_paths`` ``cuda-kernel`` only.  Prints per rank
             prefill s, decode s a step, bytes sent by kind (the
             sampler's gathers apart), the EC ms and bytes, kernel-11
             and kernel-1 launches and peak GB;
20. train-ranks - starcoder2-3b at full width, depth cut to 4 of 30
             layers (the card's memory, then the script's time), bf16, remat
             "full", "seq", trained over (data 2, model 2): four gloo
             ranks on this card, each drawing its blocks of the seed's
             weights (``ranked.init_blocks``) and running
             ``launch.train.train_on_rank`` (``RankModel`` under autograd,
             kernel 11 on its stripes in the forward and the recompute,
             AdamW on its blocks, an RS(3,2) ``ECCheckpoint(comm=...)``:
             ``launch.train --ec``'s defaults) for two steps of B 2 x S
             2,048.  The parent first runs the one-card bf16 step 1 on the
             same weights and batch and frees it.  Each rank's step-1
             loss, norm and attention weight gradient blocks must hold to
             phase 12's bounds measured on the cut model (twice bf16
             plain's distance from its fp32 twin), and a faulted control (every gradient reduce-scatter
             keeping the next index's block) must miss them; after each
             step the parity must equal a fresh encode of the new blocks,
             and after the run data position 0 must rebuild byte for byte;
             kernels 11 and 1 must launch on every rank, ``op_paths``
             ``cuda-kernel`` only; a step's bytes sent by kind must equal
             ``dryrun.count_rank_train`` at the rank's coordinates.
             Prints per rank its seconds a step, kernel-11 launches, peak
             GB, and the card's peak;
21. recurrent-ranks - the recurrent layer kinds over (data 2, model 2),
             four gloo ranks on this card, each holding its blocks of the
             parent's one-card models: (a) recurrentgemma-2b at full width,
             one "RRW" unit (3 of 26 layers), (b) mamba2-370m at full
             width, 12 of 48 layers.  Each: a bf16 prefill of 2 x 2,048, each
             rank's logits block within ``MODEL_RANKS_TWIN_MULTIPLE``
             times the one-card bf16 logits' distance from an fp32 twin;
             on the fp32 twin, a 1-token prompt and 4 greedy decode steps
             with the cache protected by RS(1,1) over "data", the tokens
             equal to the one-card fp32 engine's, the pages equal to the
             stacked one-card store's over the gathered cache, the parity
             a fresh encode, data position 0 rebuilt byte for byte and a
             flipped parity byte changing the rebuild; then two bf16
             steps of ``launch.train.train_on_rank`` with adamw8bit (a)
             or adafactor (b), step 1's loss and norm within
             train-ranks' bounds of the one-card step, the replicated
             state within twice the one-card bf16 state's distance from
             its fp32 twin's, by kind of state leaf.  Every prefill's,
             decode step's and step 2's bytes by kind must equal the dry
             run's count; kernel 11 launches once an attention layer a
             prefill and twice a step, kernel 1 in the EC calls, the
             card's paths only.  Prints per rank the seconds, the bytes
             by kind and the kernel-11 and kernel-1 launches;
22. mla-ranks - minicpm3-4b (MLA) at full width (d_model 2,560, 40
             heads, q_lora 768, kv_lora 256, nope 64, rope 32, v 64, d_ff
             6,400, vocab 73,448), depth cut to 2 of 62 layers, over
             (data 2, model 2) as phase 21 runs its archs: a bf16
             prefill of 2 x 2,048 (each rank's ``_mla_blockwise`` on its
             stripe of Q tiles), each rank's logits block within
             ``MODEL_RANKS_TWIN_MULTIPLE`` times the one-card bf16 logits'
             distance from an fp32 twin; on the fp32 twin the protected
             greedy session (1-token prompt, 4 steps over the
             sequence-sharded latent cache, RS(1,1) over "data"): tokens
             equal to the one-card fp32 engine's, pages to the stacked
             store's, a fresh parity, data position 0 rebuilt byte for
             byte, a flipped parity byte changing the rebuild; two bf16
             AdamW steps of ``train_on_rank``, step 1's loss and norm
             within train-ranks' bounds.  Every prefill's, decode step's
             and step 2's bytes by kind must equal the dry run's count;
             kernel 11 launches 0 times, kernel 1 in the EC calls, the
             card's paths only.  Prints per rank the seconds, the bytes
             by kind and the launches;
23. moe-ranks - the MoE archs' experts over (data 2, model 2), four
             gloo ranks on this card, each routing every token of its
             batch rows and running its E/2 experts, a partial output
             summed by an all-reduce over "model": (a) kimi-k2-1t-a32b at
             full width (384 experts, top-8, 64 heads on the "head"
             path, d_ff 2,048), 1 of 61 layers, bf16, the ranks on their
             blocks of the parent's one-card model: a prefill of 2 x 256
             (cap 7: assignments drop); a token is settled when its
             top-8 experts and keep flags equal the one card's, every
             other token must be explained (its own route flipped at a
             near tie, or it shares in its row an expert that a flipped
             assignment entered) and the settled tokens' logits must lie
             within ``BF16_LOGIT_TOL`` of the one card's, the share
             settled printed; then one protected ``ServeEngine`` decode
             step on a one-token prompt (RS(1,1) over "data": the parity
             a fresh encode, position 0 rebuilt equal to its live pages,
             a flipped parity byte caught); (b) both MoE archs at their
             reduced configs in fp32 through phase 21's checks (prefill 2
             x 2,048, 8 greedy protected steps, two AdamW steps), routes,
             drop set and tokens exactly the one card's, the logits
             within ``MOE_RANKS_FP32_TOL``.  Both: bytes by kind equal to
             the dry run's count, kernel 11 once an attention layer a
             prefill, kernel 1 in the EC calls, the card's paths only.
             Prints per rank prefill s, decode s and peak GB;
24. dryrun - ``launch/dryrun.py``'s count of starcoder2-3b's training
             step at phase 12's cut (B 2 x S 2,048, remat "full",
             AdamW, the 1 x 1 mesh), made on ``meta``, against the same
             step on the card: the argument bytes asked of the allocator
             and a ``FlopCounterMode`` count of the step (kernel 11 by
             its formula) must equal the prediction; the predicted and
             measured peaks and the step's share of 989 TFLOP/s are
             printed, with the EC cells' collective bytes on the 16 x 16
             mesh; then ``python -m repro_torch.launch.dryrun --mesh
             single`` over the ten archs' decode and prefill cells (a
             process a group of archs), after every timed phase, must
             record every cell ``ok`` or ``skipped`` with its reason.

Every phase prints its seconds.

While phases 4-8 run, ``ShapeLog`` counts each call of kernels 1-8 by
shape, and after them its calls must add up to the launches those phases
counted (a call reached through a binding it does not wrap fails the
run); then every shape is timed and each kernel's loss per run, calls x
(kernel ms - bound ms), is printed beside its launches.
Kernel 10 is also held against its plain version on the real object
index of a server of the loaded RS testbed.  Every phase of 4-24 starts
with the launch counts at 0 and reads them when it ends; launches made
to compare a kernel with its plain version are not counted.  The line
before the last is ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import copy
import gc
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/gf256.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"

# H100 SXM data sheet: 3.35 TB/s of HBM; 1,979 TOP/s int8 is the card's
# highest rate for byte operations, so ops / that rate is a floor for any
# byte-wise formulation of a GF(2^8) multiply-XOR; 989 TFLOP/s is its
# dense bf16 tensor-core rate, the floor for attention's bf16 products,
# and 67 TFLOP/s its fp32 rate outside the tensor cores (attention in fp32)
HBM_BYTES_PER_S = 3.35e12
BYTE_OPS_PER_S = 1.979e15
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

OBJECTS = 200_000        # the smallest load at which the testbed seals
BATCH = 64               # YCSB multi-key window
# workload ops: A, A with a data server down, A and D with a parity
# server down
OPS = dict(A=20_000, degraded=5_000, parity_down=2_000)
# the sharded phase: four testbed shards on a ring; at this load the
# smallest shard (22.5 % of the keys) holds about 54,000 objects and
# seals chunks (each shard starts sealing near 40,000)
SHARDED_OBJECTS = 240_000
SHARDED_OPS = dict(A=20_000, degraded=5_000, hot=4_000)
# keys ``rebalance`` moves in one pass; the rest stay forwarded and
# readable (an uncapped pass moves ~100,000 keys at this load)
REBALANCE_MOVES = 20_000
# the dry-run CLI's cells in the dryrun phase, the ten archs' decode and
# prefill: ~40 s of the host's CPU (minicpm3-4b's tiled MLA prefill ~31 s
# of it) where every cell takes ~70 s
CLI_SHAPES = ("decode_32k", "prefill_32k")
# the ten archs in groups of about equal counting time (CPU s of both
# shapes on one x86 core, seven processes side by side: minicpm3-4b's MLA
# prefill ~36, the dense three with mamba2-370m ~25, recurrentgemma-2b's
# rank counts ~23, the MoE two's ~18 since they count ranks, the rest
# ~9), one process a group
CLI_GROUPS = ("minicpm3-4b", "recurrentgemma-2b",
              "kimi-k2-1t-a32b,llama4-maverick-400b-a17b",
              "mamba2-370m,starcoder2-3b,phi4-mini-3.8b,mistral-large-123b",
              "qwen2-vl-7b,musicgen-medium")


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

# the bf16 flash body: one instantiation per head dim (16, 32, 64, 112,
# 128, 256)
WGMMA_BODY = "flash_attention_wgmma_kernel"
WGMMA_INSTANTIATIONS = 6
CUDA_CORE_BODY = "flash_attention_kernel"


def sass_check(lib: Path, nvcc: str) -> dict:
    """Count HGMMA (wgmma) and UTMALDG (TMA tensor loads) in the SASS of
    each instantiation of the bf16 flash body in the built library; every
    one must hold both."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if WGMMA_BODY in name:
            counts[name] = {"HGMMA": fn.count("HGMMA"),
                            "UTMALDG": fn.count("UTMALDG")}
    assert len(counts) == WGMMA_INSTANTIATIONS, counts
    for name, c in counts.items():
        assert c["HGMMA"] > 0 and c["UTMALDG"] > 0, (name, c)
    return counts


def cuda_ms(torch, fn, reps: int) -> float:
    """CUDA-event time of a run of ``reps`` calls of ``fn`` after a
    warm-up, over ``reps``: what one call costs its caller, the wrapper's
    host work (coefficient copy, allocation, launch) included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_device_ms(torch, fn, reps: int) -> float:
    """Device time per call of ``fn``: CUDA events around one replay of a
    CUDA graph that holds ``reps`` calls, captured after a warm-up.  The
    wrapper's host work runs once, at capture, so the replay is the
    kernels back to back; unlike ``kernel_device_ms`` it needs no
    profiler trace, which late in this script's run can keep no kernel
    at all."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(torch, fn, reps: int, cuda_name: str):
    """The kernel's own device time per call, and the host-to-device
    copies in the window, from a ``torch.profiler`` (CUPTI) trace of
    ``reps`` calls of ``fn``: the mean duration of the CUDA kernels whose
    name holds ``cuda_name``, times the launches the wrappers counted in
    the window, over ``reps`` (a call split into several launches counts
    them all), and the trace's ``Memcpy HtoD`` events.  The count comes
    from the wrappers because a trace can lose kernels: late in this
    script's run, traces of 50 calls have held fewer than 50, which a sum
    over the trace would read as a faster kernel.  None when the trace
    kept no such kernel."""
    from repro_torch.kernels import launch_counts
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    before = sum(launch_counts().values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launched = sum(launch_counts().values()) - before
    events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    spans = [ev.time_range.elapsed_us() for ev in events
             if cuda_name in ev.name]
    htod = sum(1 for ev in events if "HtoD" in ev.name)
    if not spans:
        return None, htod
    return sum(spans) / len(spans) * launched / reps / 1e3, htod


def raises_no_sync(torch, fn) -> None:
    """One call of ``fn`` under sync-debug mode "error": any operation
    that waits on the stream (a pageable copy to the card, a read-back)
    raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def bound(nbytes: int, ops: int,
          ops_per_s: float = BYTE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmul_work(np, A, data, gf01=False):
    """Bytes a shared-matrix product must move (each input once, each
    output once, the matrix as the kernel reads it) and its
    multiply-XORs: one per nonzero coefficient and output byte."""
    B, k, C = data.shape
    m = A.shape[0]
    mat = m * -(-k // 32) * 4 if gf01 else m * k
    return B * k * C + B * m * C + mat, int(np.count_nonzero(A)) * B * C


def per_item_work(np, Ms, blocks, parity=None):
    """Blocks in, parity in and out (or the product out), the matrices as
    the kernel reads them (row masks for 0/1 matrices, else bytes); one
    multiply-XOR per nonzero coefficient and byte."""
    from repro_torch.kernels import coefs
    B, O, J = Ms.shape
    C = blocks.shape[2]
    out = (2 if parity is not None else 1) * B * O * C
    mats = coefs.per_item_coefs(Ms)[1].size
    return mats + B * J * C + out, int(np.count_nonzero(Ms)) * C


def delta_work(np, parity, g, xor):
    """The xor in, parity in and out (or the deltas out), one byte per
    gamma; one multiply-XOR per nonzero gamma and byte."""
    B, m = g.shape
    C = xor.shape[1]
    out = (2 if parity is not None else 1) * B * m * C
    return B * m + B * C + out, int(np.count_nonzero(g & 255)) * C


def single_matmul_work(np, A, data):
    """The single-stripe product's bytes (data in, result out, the
    matrix) and multiply-XORs (one per nonzero coefficient and byte)."""
    k, C = data.shape
    m = A.shape[0]
    return k * C + m * C + m * k, int(np.count_nonzero(A)) * C


def single_delta_work(np, parity, g, old, new):
    """Parity, old and new read once, parity written once, the gammas
    (a byte each); one multiply-XOR per nonzero gamma and byte."""
    m, C = parity.shape
    g = np.asarray(g)
    return 2 * m * C + 2 * C + m, int(np.count_nonzero(g & 255)) * C


def probe_work(np, num_buckets, h1, h2):
    """Bytes the probe's queries touch, not the table: per query its
    fingerprint (8 B), two bucket ids (8 B) and two outputs (5 B), and per
    distinct bucket it names one row of 4 fingerprints and 4 occupancy
    bytes (36 B); one 64-bit compare per slot read."""
    rows = 1 + ((h1 % np.uint64(num_buckets)) != (h2 % np.uint64(num_buckets)))
    n_rows = int(rows.sum())
    return 21 * len(h1) + 36 * n_rows, 4 * n_rows


def probe_table(np, buckets: int, occupancy: float, queries: int, seed: int):
    """A cuckoo table of ``buckets`` x 4 random fingerprints, about
    ``occupancy`` of the slots occupied, and ``queries`` probes: half hit
    an occupied slot through the bucket their h1 or h2 names, half miss,
    and one in 16 has h1 == h2 (both probes on one bucket).  numpy from a
    fixed seed."""
    rng = np.random.default_rng(seed)

    def u64(n):
        return np.frombuffer(rng.bytes(8 * n), dtype=np.uint64).copy()
    fps = u64(buckets * 4).reshape(buckets, 4)
    occ = rng.random((buckets, 4)) < occupancy
    B = np.uint64(buckets)
    hits = queries // 2
    pick = rng.choice(np.flatnonzero(occ), hits)
    named = (pick // 4).astype(np.uint64) + B * (u64(hits) >> np.uint64(21))
    other = u64(hits)
    side = rng.random(hits) < 0.5
    h1 = np.concatenate([np.where(side, named, other), u64(queries - hits)])
    h2 = np.concatenate([np.where(side, other, named), u64(queries - hits)])
    fp = np.concatenate([fps.reshape(-1)[pick], u64(queries - hits)])
    same = rng.random(queries) < 1 / 16
    h2[same] = h1[same]
    order = rng.permutation(queries)
    return fps, occ, h1[order], h2[order], fp[order]


def kernel_specs(np, torch, dev):
    """Per kernel: how to make its inputs at (B, C), call the wrapper and
    the plain version, the (B, C) grid it is checked on, the width it is
    timed at (the main path's), and the bytes and operations that these
    inputs need."""
    from repro_torch.core.codes import make_code
    from repro_torch.core.engine import NumpyEngine, block_rep
    du = importlib.import_module("repro_torch.kernels.delta_update")
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    cl = importlib.import_module("repro_torch.kernels.cuckoo_lookup")

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def fused(scheme, n, k, avail, wanted):
        """The fused decode matrix [inv ; G_par o inv] the engine builds
        for one erasure pattern."""
        eng = NumpyEngine(make_code(scheme, n, k))
        return eng._fused_decode_matrix(
            eng.plan_decode([avail], [wanted], 4096).groups[0])

    E = block_rep(make_code("rs", 10, 8)).encode          # (2, 8) encode
    # fused decode of two lost data chunks, re-encoding both parities:
    # [inv ; G_par o inv] is (10, 8), the largest RS(10,8) decode matrix
    rs_dec = fused("rs", 10, 8, range(2, 10), (0, 1, 8, 9))
    # RS(14,10): a lost data chunk, all four parities re-encoded
    f4_dec = fused("rs", 14, 10, range(1, 14), (0, 10, 11, 12, 13))
    E14 = block_rep(make_code("rs", 14, 10)).encode       # (4, 10) encode
    # RDP(10,8), r = 16: the (32, 128) block encode matrix and the fused
    # decode of two lost data chunks with both parities, (160, 128)
    rdp = make_code("rdp", 10, 8)
    R = block_rep(rdp).encode
    r = R.shape[0] // 2
    rdp_dec = fused("rdp", 10, 8, range(2, 10), (0, 1, 8, 9))
    # the one-chunk decode, the main path's most called RDP matrix (1-8
    # set bits a row)
    rdp_dec1 = fused("rdp", 10, 8, [p for p in range(10) if p != 3], (3,))
    assert gm.choose_strategy(rs_dec) == "unroll"
    assert gm.choose_strategy(f4_dec) == "cols" and f4_dec.shape == (14, 10)
    assert gm.choose_strategy(E14) == "unroll" and E14.shape == (4, 10)
    assert gm.choose_strategy(R) == "gf01" and R.shape == (32, 128)
    assert gm.choose_strategy(rdp_dec) == "gf01"
    assert rdp_dec.shape == (160, 128)
    assert gm.choose_strategy(rdp_dec1) == "gf01"
    assert rdp_dec1.shape == (128, 128)

    RS_C, RDP_C = (4096, 1000), (4096, 1000, 256)

    def batched(check_C, time_C, main_B=()):
        """The (B, C) grid a batched kernel is checked on, and its timed
        points at the main path's width (and batches ``main_B``)."""
        return dict(check=[(B, C) for C in check_C
                           for B in (1, 64, 4096, *main_B)],
                    timed=[("b4096", (4096, time_C), 20),
                           ("b64", (64, time_C), 200)]
                    + [(f"b{B}", (B, time_C), 200) for B in main_B])

    def matmul(A, strategy, check_C, time_C, main_B=()):
        m, k = A.shape
        plain = (gm.gf01_matmul_batched_plain if strategy == "gf01"
                 else gm.gf256_matmul_batched_plain)
        return dict(make=lambda B, C: (A, u8((B, k, C))),
                    kernel=gm.gf256_matmul_batched, plain=plain,
                    work=lambda a: matmul_work(np, *a,
                                               gf01=strategy == "gf01"),
                    **batched(check_C, time_C, main_B))

    def general(Ms):
        """A general matrix of Ms's shape, with 0 and 1 entries beside
        the rest (the byte form of the per-item kernels)."""
        G = rng.integers(0, 256, Ms.shape, dtype=np.uint8)
        G[::3, :, 0] = 0
        G[1::3, :, 0] = 1
        return G

    def rdp_delta_make(B, C, form="01"):
        """What ``submit_delta`` hands the kernel for RDP: per item the
        (m*r, r) columns of the data chunk it mutates (0/1, row masks);
        ``form="general"`` a general matrix of the same shape."""
        idx = rng.integers(0, rdp.k, B)
        cols = R.reshape(2 * r, rdp.k, r)[:, idx, :]
        Ms = np.ascontiguousarray(np.transpose(cols, (1, 0, 2)))
        return (general(Ms) if form == "general" else Ms), u8((B, r, C))

    def fold_make(O):
        def make(B, C, form=None):
            if O == 1:
                Ms = (rng.integers(0, 2, (B, 1, 1), dtype=np.uint8)
                      if form == "01"
                      else rng.integers(1, 256, (B, 1, 1), dtype=np.uint8))
            else:
                # RDP seal: the (r, r) system of one parity row and chunk
                E4 = R.reshape(2, r, rdp.k, r)
                Ms = np.ascontiguousarray(E4[rng.integers(0, 2, B), :,
                                             rng.integers(0, rdp.k, B), :])
                if form == "general":
                    Ms = general(Ms)
            return (Ms, u8((B, O, C)), u8((B, O, C)))
        return make

    def delta_make(parity):
        def make(B, C, form=None):
            g = rng.integers(0, 256, (B, 2)).astype(np.int32)
            if form == "01":        # zero and one gammas beside the rest
                g[::3, 0] = 0
                g[1::3, 1] = 1
            return ((u8((B, 2, C)) if parity else None), g, u8((B, C)))
        return make

    def by_value(case, extra):
        """Kernels 4-7 take their coefficients in the launch parameters:
        their grid adds the other coefficient form at B = 64 and a batch
        whose coefficients exceed the largest parameter tier (split into
        several launches)."""
        case["check"] = case["check"] + extra
        return case

    def per_item_case(make, check_C, time_C, extra):
        return by_value(dict(make=make,
                             kernel=gm.gf256_matmul_per_item_batched,
                             plain=gm.gf256_matmul_per_item_plain,
                             work=lambda a: per_item_work(np, *a),
                             **batched(check_C, time_C)), extra)

    def delta_case(parity):
        return by_value(dict(make=delta_make(parity),
                             kernel=du.delta_apply_batched,
                             plain=du.delta_apply_batched_plain,
                             work=lambda a: delta_work(np, *a),
                             **batched(RS_C, 4096)),
                        [(64, 4096, "01"), (64, 1000, "01"), (20000, 256),
                         (20000, 256, "01")])

    # kernels 8-10, the single-stripe entries of kernels/ops.py and the
    # index probe: RS(10,8) encode (2,8) and the decode inverse of two lost
    # data chunks (8,8), at one 4 KB chunk and at 1 MiB
    rs = make_code("rs", 10, 8)
    inv, _ = rs.decode_matrix(list(range(2, 10)))
    assert inv.shape == (8, 8) and gm.choose_strategy(inv) == "unroll"
    WIDE = 1 << 20

    def single(A):
        k = A.shape[1]
        return dict(make=lambda C: (A, u8((k, C))), kernel=gm.gf256_matmul,
                    plain=gm.gf256_matmul_plain,
                    work=lambda a: single_matmul_work(np, *a),
                    check=[(4096,), (1000,), (WIDE,)],
                    timed=[("c4096", (4096,), 200), ("c1048576", (WIDE,), 20)])

    def single_delta_make(C, m=2, form=None):
        g = rng.integers(1, 256, m).astype(np.int32)
        if form == "01":            # a zero and a one gamma beside the rest
            g[0], g[-1] = 0, 1
        return (u8((m, C)), g, u8((C,)), u8((C,)))

    # the probe: 2^20 buckets (4 M slots, 90 % occupied, 36 MB of table
    # on the card), Q = 64 (a YCSB window) and Q = 65,536
    fps, occ, h1, h2, fp = probe_table(np, 1 << 20, 0.9, 1 << 16, seed=20)
    fps_d = torch.from_numpy(fps.view(np.int64)).to(dev)
    occ_d = torch.from_numpy(occ).to(dev)

    def probe_plain(fps_t, occ_t, a, b, f):
        return cl.cuckoo_probe_plain(
            fps_t, occ_t, *cl.query_tensors(a, b, f, fps_t.shape[0],
                                            fps_t.device))

    # ``cuda_name``: the __global__ function in csrc/gf256.cu, as the
    # profiler names the launch
    return [
        dict(name="gf_matmul_batched", cuda_name="matmul_batched_kernel",
             by_value=True, replaces="src/repro/kernels/gf256_matmul.py:95",
             cases={"decode_10x8": matmul(rs_dec, "unroll", RS_C, 4096),
                    "encode_2x8": matmul(E, "unroll", RS_C, 4096),
                    "encode_4x10": matmul(E14, "unroll", RS_C, 4096)}),
        dict(name="gf_matmul_cols_batched",
             cuda_name="matmul_cols_kernel", by_value=True,
             replaces="src/repro/kernels/gf256_matmul.py:124",
             cases={"decode_14x10": matmul(f4_dec, "cols", RS_C, 4096)}),
        # either body: gf01_tile_kernel or gf01_direct_kernel; B 36 is the
        # main path's most called (144, 128) decode's batch
        dict(name="gf01_matmul_batched", cuda_name="gf01_",
             by_value=True, replaces="src/repro/kernels/gf256_matmul.py:154",
             cases={"encode_32x128": matmul(R, "gf01", RDP_C, 256, (36,)),
                    "decode_160x128": matmul(rdp_dec, "gf01", RDP_C, 256,
                                             (36,)),
                    "decode_128x128": matmul(rdp_dec1, "gf01", RDP_C, 256,
                                             (36,))}),
        dict(name="gf_per_item",
             cuda_name="per_item_kernel", by_value=True,
             replaces="src/repro/kernels/gf256_matmul.py:297",
             cases={"delta_Bx32x16": per_item_case(
                 rdp_delta_make, RDP_C, 256,
                 [(64, 256, "general"), (64, 1000, "general"),
                  (1100, 256), (300, 256, "general")])}),
        dict(name="gf_per_item_fold",
             cuda_name="per_item_kernel", by_value=True,
             replaces="src/repro/kernels/gf256_matmul.py:302",
             cases={"fold_Bx1x1": per_item_case(
                 fold_make(1), RS_C, 4096,
                 [(64, 4096, "01"), (64, 1000, "01"), (40000, 64)]),
                 "fold_Bx16x16": per_item_case(
                     fold_make(r), RDP_C, 256,
                     [(64, 256, "general"), (64, 1000, "general"),
                      (2100, 256), (300, 256, "general")])}),
        dict(name="gf_delta_apply_batched",
             cuda_name="delta_batched_kernel", by_value=True,
             replaces="src/repro/kernels/delta_update.py:74",
             cases={"apply_m2": delta_case(True)}),
        dict(name="gf_delta_only_batched",
             cuda_name="delta_batched_kernel", by_value=True,
             replaces="src/repro/kernels/delta_update.py:80",
             cases={"delta_m2": delta_case(False)}),
        dict(name="gf_matmul", cuda_name="matmul_batched_kernel",
             by_value=True, replaces="src/repro/kernels/gf256_matmul.py:66",
             cases={"encode_2x8": single(rs.parity_matrix),
                    "decode_8x8": single(inv)}),
        dict(name="gf_delta_update", cuda_name="delta_update_kernel",
             by_value=True, replaces="src/repro/kernels/delta_update.py:28",
             cases={"update_m2": dict(
                 make=single_delta_make, kernel=du.delta_update,
                 plain=du.delta_update_plain,
                 work=lambda a: single_delta_work(np, *a),
                 check=[(4096,), (1000,), (WIDE,), (4096, 2, "01"),
                        (4096, 4), (1000, 4, "01"), (WIDE, 4, "01")],
                 timed=[("c4096", (4096,), 200),
                        ("c1048576", (WIDE,), 20)])}),
        dict(name="gf_cuckoo_probe", cuda_name="cuckoo_probe_kernel",
             replaces="src/repro/kernels/cuckoo_lookup.py:29",
             cases={"probe_2e20": dict(
                 make=lambda Q: (fps_d, occ_d, h1[:Q], h2[:Q], fp[:Q]),
                 kernel=cl.cuckoo_lookup, plain=probe_plain,
                 work=lambda a: probe_work(np, a[0].shape[0], a[2], a[3]),
                 check=[(1,), (64,), (1 << 16,)],
                 timed=[("q64", (64,), 200), ("q65536", (1 << 16,), 20)])}),
    ]


def flash_work(q, k, v, causal):
    """Bytes of one attention call (q, k, v and the output, each once)
    and the operations this call needs: 2 per multiply-add of Q Kᵀ and of
    P V over the (query, key) pairs that the causal mask keeps."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    pairs = (sum(min(i + 1, Skv) for i in range(Sq)) if causal
             else Sq * Skv)
    return nbytes, 4 * B * H * hd * pairs


# kernel 11 at the head dims the other model families need: the
# recurrentgemma-2b prefill (B 4, S 2,048, H 10, KV 1, hd 256) and the
# kimi-k2 prefill (B 1, S 2,048, H 64, KV 8, hd 112), causal, bf16
RG2B_PREFILL = (4, 2048, 10, 1, 256, True, "bfloat16")
KIMI_PREFILL = (1, 2048, 64, 8, 112, True, "bfloat16")


def flash_spec(torch, dev):
    """Kernel 11 on the grid of ``tests/test_flash_attention.py`` in fp32
    and bf16, non-causal at S = 128 and at the ragged S = 100, the
    starcoder2-3b prefill shape (B = 4, S = 2048, H = 24, KV = 2,
    hd = 128) in fp32 and bf16, and the train phase's shapes (B = 2 of
    those; the reduced config's B = 2, S = 32, H = 4, KV = 2, hd = 16)
    in bf16; at hd 112 and 256 in both dtypes, causal and not, with a
    ragged Skv, and at the recurrentgemma-2b and kimi-k2 prefill shapes;
    each element within its bound (``kernels.flash_attention.tolerance``);
    timed at the prefill shape and at B = 1, S = 256 (launch-dominated) in
    bf16, at the prefill shape in fp32, and at the two new prefill shapes,
    beside scaled_dot_product_attention.  bf16 runs the wgmma body, fp32
    the CUDA-core body; each point's bound takes the peak rate of its
    dtype."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def make(B, S, H, KV, hd, causal, dtype, Skv=None):
        def t(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                getattr(torch, dtype))
        Skv = S if Skv is None else Skv
        return t(B, S, H, hd), t(B, Skv, KV, hd), t(B, Skv, KV, hd), causal

    def library(q, k, v, causal):
        # timed only, as the yardstick; the port never calls it
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)

    ref_grid = [(2, 256, 4, 2, 64), (1, 200, 8, 8, 32), (2, 384, 6, 3, 128),
                (1, 64, 2, 1, 16)]
    prefill = (4, 2048, 24, 2, 128, True, "bfloat16")
    # hd 112 and 256: causal, non-causal, ragged Skv both ways
    new_dims = [(2, 300, 8, 2, 112, True), (1, 200, 4, 2, 112, False, 100),
                (1, 100, 4, 2, 112, True, 300), (2, 300, 10, 1, 256, True),
                (1, 200, 4, 1, 256, False, 100),
                (1, 100, 10, 1, 256, True, 300)]
    check = ([(*g, True, dt) for dt in ("float32", "bfloat16")
              for g in ref_grid]
             + [(*g, False, dt) for dt in ("float32", "bfloat16")
                for g in ((1, 128, 4, 4, 32), (1, 100, 2, 2, 16))]
             + [prefill[:-1] + ("float32",), prefill,
                (2, 2048, 24, 2, 128, True, "bfloat16"),     # the train step
                (2, 2048, 10, 1, 256, True, "bfloat16"),     # train-hybrid
                (2, 32, 4, 2, 16, True, "bfloat16")]         # launch.train
             + [(*g[:6], dt, *g[6:]) for dt in ("float32", "bfloat16")
                for g in new_dims]
             + [RG2B_PREFILL, RG2B_PREFILL[:-1] + ("float32",),
                KIMI_PREFILL, KIMI_PREFILL[:-1] + ("float32",)])
    return dict(
        name="flash_attention",
        cuda_name=lambda a: (WGMMA_BODY if a[0].dtype == torch.bfloat16
                             else CUDA_CORE_BODY),
        source=FLASH_SOURCE,
        replaces="src/repro/kernels/flash_attention.py:31",
        tolerance="per element: fp32 1e-4; bf16 1e-4 + 2 bf16 ulps of "
                  "|plain output| (kernels.flash_attention.tolerance)",
        cases={"causal_gqa": dict(
            make=make,
            kernel=lambda q, k, v, c: fa.flash_attention(q, k, v, causal=c),
            plain=lambda q, k, v, c: fa.flash_attention_plain(q, k, v,
                                                              causal=c),
            library=library, ratio=fa.tolerance_ratio,
            ops_per_s=lambda a: (BF16_FLOPS_PER_S
                                 if a[0].dtype == torch.bfloat16
                                 else FP32_FLOPS_PER_S),
            work=lambda a: flash_work(*a),
            check=check,
            timed=[("prefill_b4_s2048", prefill, 20),
                   ("b1_s256", (1, 256, 24, 2, 128, True, "bfloat16"),
                    200),
                   ("prefill_fp32", prefill[:-1] + ("float32",), 5),
                   ("rg2b_prefill_hd256", RG2B_PREFILL, 5),
                   ("kimi_prefill_hd112", KIMI_PREFILL, 20)])})


def flash_controls(torch, dev) -> dict:
    """The faulted control at the new head dims: kernel 11 with its last
    64 query rows skipping their own key (``faulted_attention``) must miss
    the per-element tolerance against the plain version, at hd 112 and
    256 in bf16.  Returns the worst ratios, each > 1."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    bad = faulted_attention(torch, fa)
    out = {}
    for hd, H, KV in ((112, 8, 2), (256, 10, 1)):
        q, k, v = (torch.randn((2, 256, h, hd), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for h in (H, KV, KV))
        ratio = fa.tolerance_ratio(bad(q, k, v), fa.flash_attention_plain(
            q, k, v))
        assert ratio > 1.0, f"the faulted control holds at hd {hd}: {ratio}"
        out[f"hd{hd}"] = ratio
    return out


def max_err(torch, got, want):
    """Largest absolute difference over a kernel's output(s): an int for
    byte outputs, a float (compared in fp32) for floating ones."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)

    def one(g, w):
        if not g.numel():
            return 0
        if g.is_floating_point():
            return float((g.float() - w.float()).abs().max())
        return int((g.int() - w.int()).abs().max())
    return max(one(g, w) for g, w in zip(got, want))


def run_kernels(np, torch, dev):
    """Hold every kernel against its plain version; time both."""
    rows = []
    for spec in kernel_specs(np, torch, dev) + [flash_spec(torch, dev)]:
        row = dict(name=spec["name"], route="cuda",
                   source=spec.get("source", SOURCE),
                   replaces=spec["replaces"], checked=[], max_abs_err=0,
                   tolerance=spec.get("tolerance", "exact"))
        for case_name, case in spec["cases"].items():
            for shape in case["check"]:
                args = case["make"](*shape)
                got = case["kernel"](*args)
                want = case["plain"](*args)
                torch.cuda.synchronize()
                err = max_err(torch, got, want)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                if "ratio" in case:
                    # a bound per element: the worst |got - want| over it
                    ratio = case["ratio"](got, want)
                    if not ratio <= 1.0:
                        raise AssertionError(
                            f"{spec['name']} {case_name} {shape}: an element "
                            f"is {ratio} times its tolerance off the plain "
                            f"version (max abs err {err})")
                    row["worst_tolerance_ratio"] = max(
                        row.get("worst_tolerance_ratio", 0.0), ratio)
                    row["checked"].append(f"{case_name} {shape}: err {err}, "
                                          f"{ratio} of the tolerance")
                else:
                    if err > 0:
                        raise AssertionError(
                            f"{spec['name']} {case_name} {shape}: max abs "
                            f"err {err} against the plain version (exact)")
                    row["checked"].append(f"{case_name} {shape}: err {err}")
                del args, got, want
            timing = {}
            for label, shape, reps in case["timed"]:
                args = case["make"](*shape)
                call = lambda: case["kernel"](*args)          # noqa: E731
                ms = cuda_ms(torch, call, reps)
                cuda_name = spec["cuda_name"]
                if callable(cuda_name):
                    cuda_name = cuda_name(args)
                kernel_ms, htod = kernel_device_ms(torch, call, reps,
                                                   cuda_name)
                if spec.get("by_value"):
                    # coefficients in the launch parameters: no copy to
                    # the card and no wait on the stream
                    assert htod == 0, f"{spec['name']} {label}: {htod} HtoD"
                    raises_no_sync(torch, call)
                plain_ms = cuda_ms(torch, lambda: case["plain"](*args),
                                   max(3, reps // 10))
                library_ms = (cuda_ms(torch, lambda: case["library"](*args),
                                      reps) if "library" in case else None)
                nbytes, ops = case["work"](args)
                rate = case.get("ops_per_s", BYTE_OPS_PER_S)
                if callable(rate):
                    rate = rate(args)
                b_ms, by = bound(nbytes, ops, rate)
                timing[label] = dict(ms=ms, kernel_ms=kernel_ms,
                                     plain_ms=plain_ms, library_ms=library_ms,
                                     bound_ms=b_ms, bound_by=by,
                                     bytes=nbytes, ops=ops)
                flops_txt = ""
                if "ops_per_s" in case and kernel_ms is not None:
                    # floating-point operations over the kernel's own time
                    timing[label]["tflops"] = ops / kernel_ms / 1e9
                    flops_txt = (f", {timing[label]['tflops']:.1f} TFLOP/s "
                                 f"achieved")
                kernel_txt = ("not measured (no device time in the trace)"
                              if kernel_ms is None else f"{kernel_ms:.4f} ms")
                library_txt = ("" if library_ms is None
                               else f", library {library_ms:.4f} ms")
                log(f"kernel {spec['name']} {case_name} {label} {shape}: "
                    f"wrapper {ms:.4f} ms, kernel {kernel_txt} (plain "
                    f"{plain_ms:.4f} ms{library_txt}, bound {b_ms:.4f} ms "
                    f"by {by}, {nbytes} bytes, {ops} operations"
                    f"{flops_txt})")
                del args
            row.setdefault("cases", {})[case_name] = {
                "shapes": {label: str(shape)
                           for label, shape, _ in case["timed"]},
                **{f"{k}_{label}": v for label, t in timing.items()
                   for k, v in t.items()}}
            if "ms" not in row:       # the first timed point is the headline
                label, shape, _ = case["timed"][0]
                t = timing[label]
                row.update(ms=t["ms"], kernel_ms=t["kernel_ms"],
                           plain_ms=t["plain_ms"],
                           bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                           library_ms=t["library_ms"],
                           shape=f"{case_name} {label} {shape}")
        rows.append(row)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows


def engine_calls(np, torch) -> dict:
    """Host time of one engine call around kernels 1, 5 and 6, at the YCSB
    window (B = 64) and 4 KB chunks: ``submit_apply_delta(...).result()``
    on RS(10,8) (a sealed UPDATE batch: kernel 6),
    ``submit_fold_rows(...).result()`` on RS(10,8) and RDP(10,8) (seal
    folds: kernel 5), and ``submit_encode`` and ``submit_decode(...)
    .result()`` on RS(10,8) (kernel 1: the (2, 8) encode, and the (10, 8)
    fused decode of two lost data chunks with both parities re-encoded),
    on the CUDA engine beside the numpy engine, timed in turns (numpy,
    cuda, cuda, numpy), 100 calls each.  The engines' results must agree.
    A measurement only: it counts toward no phase."""
    from repro_torch.core.codes import make_code
    from repro_torch.core.engine import CudaEngine, NumpyEngine
    B, C, reps = BATCH, 4096, 100
    rng = np.random.default_rng(16)
    out = {}
    for scheme in ("rs", "rdp"):
        code = make_code(scheme, 10, 8)
        engines = {"numpy": NumpyEngine(code), "cuda": CudaEngine(code)}
        idx = rng.integers(0, code.k, B)
        xors = rng.integers(0, 256, (B, C), dtype=np.uint8)
        rows = rng.integers(0, code.m, B)
        prow = rng.integers(0, 256, (B, C), dtype=np.uint8)
        par = rng.integers(0, 256, (B, code.m, C), dtype=np.uint8)
        calls = {f"fold_rows_{scheme}": lambda e: e.submit_fold_rows(
            idx, xors, rows, prow).result()}
        if scheme == "rs":
            calls["apply_delta_rs"] = lambda e: e.submit_apply_delta(
                par, idx, xors).result()
            data = rng.integers(0, 256, (B, code.k, C), dtype=np.uint8)
            stripes = np.concatenate(
                [data, engines["numpy"].encode_batch(data)], axis=1)
            avail = [{p: s[p] for p in range(2, code.n)} for s in stripes]
            wanted = [[0, 1, code.k, code.k + 1]] * B
            calls["encode_rs"] = lambda e: e.submit_encode(data).result()
            calls["decode_rs"] = lambda e: [
                [d[p] for p in w] for d, w in zip(
                    e.submit_decode(avail, wanted, C).result(), wanted)]
        for name, call in calls.items():
            got = {k: call(e) for k, e in engines.items()}
            assert np.array_equal(got["cuda"], got["numpy"]), name
            row = {}
            for k in ("numpy", "cuda", "cuda", "numpy"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    call(engines[k])
                row.setdefault(f"{k}_ms", []).append(
                    (time.perf_counter() - t0) / reps * 1e3)
            out[name] = row
    return out


# ---------------------------------------------------------------------------
# main-path shapes: what the phases call each coding kernel at
# ---------------------------------------------------------------------------

# the ShapeLog in force, if any; ``launched_in`` lets it count
SHAPE_LOG = None


class ShapeLog:
    """Counts the calls of kernels 1-8 by shape in the main-path phases'
    counted runs (``launched_in``).  It wraps the kernel wrappers where
    the engine, ``kernels.ops`` and the quickstart reach them (the module
    bindings), notes each call that launches on the card under its kernel
    and shape, keeps the first call's host coefficients of each shape,
    and calls the wrapper itself: launches and their counts are the
    wrapper's own."""

    def __init__(self, np):
        import threading
        self.np = np
        self.calls = {}          # (kernel, shape) -> [calls, coefficients]
        self.lock = threading.Lock()
        self.saved = []
        self.active = False

    def note(self, kernel, shape, coef):
        if self.active:
            with self.lock:
                self.calls.setdefault((kernel, shape), [0, coef])[0] += 1

    def _patch(self, module, name, make):
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, make(getattr(module, name)))

    def __enter__(self):
        np = self.np
        gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
        du = importlib.import_module("repro_torch.kernels.delta_update")
        ops = importlib.import_module("repro_torch.kernels.ops")

        def batched(fn):
            def call(A, data, strategy=None):
                A8 = np.ascontiguousarray(A, dtype=np.uint8)
                if data.is_cuda and data.numel() and A8.size:
                    kernel = gm._KERNEL_OF[gm.choose_strategy(A8, strategy)]
                    self.note(kernel, (A8.shape, tuple(data.shape)), A8)
                return fn(A, data, strategy)
            return call

        def single(fn):
            def call(A, data, strategy=None):
                A8 = np.ascontiguousarray(A, dtype=np.uint8)
                if (data.is_cuda and data.numel() and A8.size
                        and gm.choose_strategy(A8, strategy) == "unroll"):
                    self.note("gf_matmul", (A8.shape, tuple(data.shape)), A8)
                return fn(A, data, strategy)
            return call

        def per_item(fn):
            def call(Ms, blocks, parity=None, strategy=None):
                if blocks.is_cuda and blocks.numel() and np.size(Ms):
                    Ms8 = np.array(Ms.cpu() if hasattr(Ms, "cpu") else Ms,
                                   dtype=np.uint8)
                    self.note("gf_per_item" if parity is None
                              else "gf_per_item_fold",
                              (Ms8.shape, tuple(blocks.shape)), Ms8)
                return fn(Ms, blocks, parity, strategy)
            return call

        def delta(fn):
            def call(parity, gammas, xor):
                if xor.is_cuda and xor.numel() and np.size(gammas):
                    g = np.array(gammas.cpu() if hasattr(gammas, "cpu")
                                 else gammas)
                    self.note("gf_delta_only_batched" if parity is None
                              else "gf_delta_apply_batched",
                              (g.shape, tuple(xor.shape)), g)
                return fn(parity, gammas, xor)
            return call

        self._patch(gm, "gf256_matmul_batched", batched)
        self._patch(gm, "gf256_matmul", single)
        self._patch(ops, "gf256_matmul", single)
        self._patch(du, "gf256_matmul_per_item_batched", per_item)
        self._patch(du, "delta_apply_batched", delta)
        global SHAPE_LOG
        SHAPE_LOG = self
        return self

    def __exit__(self, *exc):
        global SHAPE_LOG
        SHAPE_LOG = None
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
        self.saved.clear()

    def check_launches(self, by_phase: dict) -> None:
        """Each kernel's logged calls, times the launches its wrapper
        plans for each shape, must equal the launches that the phases run
        under this log counted."""
        from repro_torch.kernels import coefs
        np = self.np

        def per_call(kernel, mshape, coef):
            if kernel in ("gf_per_item", "gf_per_item_fold"):
                per_item = coefs.per_item_coefs(coef)[1].size // mshape[0]
                return len(coefs.plan_launches(mshape[0], per_item))
            if kernel in ("gf_delta_apply_batched", "gf_delta_only_batched"):
                return len(coefs.plan_launches(*mshape))
            return 1

        logged = dict.fromkeys(CUDA_NAMES, 0)
        for (kernel, (mshape, _)), (n, coef) in self.calls.items():
            logged[kernel] += n * per_call(kernel, mshape, np.asarray(coef))
        launched = {k: sum(n[k] for n in by_phase.values()) for k in logged}
        assert logged == launched, (
            f"main-path calls seen by the shape log {logged} differ from "
            f"the launches counted {launched}")


# the __global__ function of each kernel 1-8, as the profiler names it
CUDA_NAMES = {"gf_matmul_batched": "matmul_batched_kernel",
              "gf_matmul_cols_batched": "matmul_cols_kernel",
              "gf01_matmul_batched": "gf01_",
              "gf_per_item": "per_item_kernel",
              "gf_per_item_fold": "per_item_kernel",
              "gf_delta_apply_batched": "delta_batched_kernel",
              "gf_delta_only_batched": "delta_batched_kernel",
              "gf_matmul": "matmul_batched_kernel"}


def main_path_losses(np, torch, dev, shape_log) -> dict:
    """Per kernel of 1-8: its calls on the main path by shape, the kernel's
    device ms and bound at every shape it was called at (random data of
    that shape, the coefficients of its first call), and the loss, calls
    x (kernel ms - bound ms), summed over them.  A shape whose trace holds
    no device time has kernel ms None, and its kernel's loss is None: no
    other time stands in.  Kernel 11 runs one main-path shape (the
    prefill), timed in the kernel phase."""
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    du = importlib.import_module("repro_torch.kernels.delta_update")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def case(kernel, shape, coef):
        """(call, bytes and operations, profiler name) of one shape."""
        mshape, dshape = shape
        if kernel in ("gf_matmul_batched", "gf_matmul_cols_batched",
                      "gf01_matmul_batched"):
            a = (coef, u8(dshape))
            return (lambda: gm.gf256_matmul_batched(*a),
                    matmul_work(np, *a, gf01=kernel == "gf01_matmul_batched"))
        if kernel == "gf_matmul":
            a = (coef, u8(dshape))
            return lambda: gm.gf256_matmul(*a), single_matmul_work(np, *a)
        if kernel in ("gf_per_item", "gf_per_item_fold"):
            B, O, _ = mshape
            a = (coef, u8(dshape),
                 u8((B, O, dshape[2])) if kernel == "gf_per_item_fold"
                 else None)
            return (lambda: gm.gf256_matmul_per_item_batched(*a),
                    per_item_work(np, *a))
        B, m = mshape
        a = (u8((B, m, dshape[1])) if kernel == "gf_delta_apply_batched"
             else None, coef, u8(dshape))
        return lambda: du.delta_apply_batched(*a), delta_work(np, *a)

    out = {}
    for kernel in sorted({k for k, _ in shape_log.calls}):
        shapes = sorted(((n, shape, coef) for (k, shape), (n, coef)
                         in shape_log.calls.items() if k == kernel),
                        key=lambda t: -t[0])
        calls = sum(n for n, _, _ in shapes)
        timed, loss = [], 0.0
        for n, shape, coef in shapes:
            call, (nbytes, ops) = case(kernel, shape, coef)
            k_ms, _ = kernel_device_ms(torch, call, 50, CUDA_NAMES[kernel])
            b_ms, _ = bound(nbytes, ops)
            loss = None if k_ms is None or loss is None \
                else loss + n * (k_ms - b_ms)
            timed.append(dict(shape=f"{shape[0]} x {shape[1]}", calls=n,
                              kernel_ms=k_ms, bound_ms=b_ms))
        out[kernel] = dict(calls=calls, distinct_shapes=len(shapes),
                           loss_ms=loss, timed=timed)
        loss_txt = ("not measured (a shape's trace held no device time)"
                    if loss is None else f"{loss:.4f} ms")
        log(f"main-path shapes {kernel}: {calls} calls at {len(shapes)} "
            f"shapes, all timed; loss {loss_txt} per run:",
            json.dumps(timed))
    return out


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------

def parity_invariant(np, cl):
    """Every sealed data chunk must decode (numpy RS) from the rest of its
    stripe; returns (checked, bad)."""
    from repro_torch.core.chunk import ChunkId
    bad = checked = 0
    cs = cl.chunk_size
    for s in cl.servers:
        for idx, cid in enumerate(s.chunk_ids):
            if cid is None or not s.sealed[idx] or cid.position >= cl.k:
                continue
            sl = cl.stripe_lists[cid.stripe_list_id]
            avail = {}
            for i in range(cl.n):
                if i == cid.position:
                    continue
                c = cl.servers[sl.servers[i]].get_sealed_chunk(
                    ChunkId(cid.stripe_list_id, cid.stripe_id, i))
                avail[i] = c if c is not None else np.zeros(cs, np.uint8)
            rec = cl.code.decode(avail, [cid.position], cs)[cid.position]
            checked += 1
            bad += 0 if np.array_equal(rec, s.region[idx]) else 1
    return checked, bad


def victim(cl, parity_side: bool) -> int:
    """The server holding the most sealed data (or parity) chunks."""
    def count(srv):
        return sum(1 for idx, cid in enumerate(srv.chunk_ids)
                   if cid is not None and srv.sealed[idx]
                   and (cid.position >= cl.k) == parity_side)
    return max(range(len(cl.servers)), key=lambda s: count(cl.servers[s]))


def sealed_chunks(cl) -> int:
    return sum(int(sum(bool(x) for x in s.sealed)) for s in cl.servers)


def scenario(cl, cfg, run_workload) -> tuple[list, dict, dict, dict]:
    """load -> A -> fail data server -> A -> restore -> fail parity server
    -> A, D -> restore.  Returns (transitions, seconds per phase, counts,
    and per ``fail_*`` phase the inputs of its engine decodes)."""
    secs, trans, decodes = {}, [], {}

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    def fail(name, sid):
        calls = []
        submit = cl.engine.submit_decode

        def recording(available, wanted, chunk_size):
            calls.append((available, wanted, chunk_size))
            return submit(available, wanted, chunk_size)
        cl.engine.submit_decode = recording
        try:
            trans.append((name, sid, phase(name, lambda: cl.fail_server(sid))))
        finally:
            del cl.engine.submit_decode
        # copied before any later request can change a chunk in place
        decodes[name] = copy.deepcopy(calls)

    phase("load", lambda: run_workload(cl, "load", 0, cfg, batch_size=BATCH))
    phase("A", lambda: run_workload(cl, "A", OPS["A"], cfg,
                                    batch_size=BATCH))
    counts = {"sealed_after_load_A": sealed_chunks(cl)}
    sid = victim(cl, False)
    fail("fail_data", sid)
    phase("A_degraded", lambda: run_workload(cl, "A", OPS["degraded"], cfg,
                                             batch_size=BATCH))
    trans.append(("restore_data", sid, phase(
        "restore_data", lambda: cl.restore_server(sid))))
    sid = victim(cl, True)
    fail("fail_parity", sid)
    phase("A_parity_down", lambda: run_workload(
        cl, "A", OPS["parity_down"], cfg, batch_size=BATCH))
    phase("D_parity_down", lambda: run_workload(
        cl, "D", OPS["parity_down"], cfg, batch_size=BATCH))
    trans.append(("restore_parity", sid, phase(
        "restore_parity", lambda: cl.restore_server(sid))))
    counts["sealed_end"] = sealed_chunks(cl)
    counts["recovered_chunks"] = {
        t[0]: t[2].get("recovered_chunks", 0) for t in trans
        if t[0].startswith("fail")}
    return trans, secs, counts, decodes


def replay_decodes(np, torch, code, decodes) -> dict:
    """Where a ``fail_server`` spends its coding time: replay the decodes
    each fail phase made on fresh engines (cold plan caches, as the
    cluster's engine met them) - the numpy engine, the plain torch
    versions on the card, and the CUDA kernels - in the order numpy,
    torch, cuda, cuda, torch, numpy.  Host seconds per replay, each ending
    in the copy back to the host; the outputs must agree."""
    from repro_torch.core.engine import CudaEngine, NumpyEngine, TorchEngine
    order = (("numpy", NumpyEngine), ("torch", TorchEngine),
             ("cuda", CudaEngine))
    out = {}
    for phase_name, calls in decodes.items():
        row = {"calls": len(calls),
               "items": sum(len(a) for a, _, _ in calls)}
        results = {}
        for name, cls in order + order[::-1]:
            eng = cls(code)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [eng.submit_decode(a, w, cs).result() for a, w, cs in calls]
            row.setdefault(f"{name}_s", []).append(time.perf_counter() - t0)
            results.setdefault(name, got)
        want = results["numpy"]
        for name, got in results.items():
            for g_call, w_call in zip(got, want):
                for g, w in zip(g_call, w_call):
                    assert g.keys() == w.keys() and all(
                        np.array_equal(g[p], w[p]) for p in w), \
                        f"{phase_name}: {name} decode differs from numpy"
        out[phase_name] = row
    return out


def contents(cl, cfg, inserted):
    from repro_torch.data.ycsb import YCSBWorkload
    w = YCSBWorkload(cfg)
    keys = [w.key(i) for i in range(cfg.num_objects + inserted)]
    out = []
    for s in range(0, len(keys), 4096):
        out.extend(cl.multi_get(keys[s:s + 4096]))
    return out


# the kernels each main-path phase must launch
RS_KERNELS = ("gf_matmul_batched", "gf_per_item_fold", "gf_delta_apply_batched",
              "gf_delta_only_batched")
RDP_KERNELS = ("gf01_matmul_batched", "gf_per_item", "gf_per_item_fold")
COLS_KERNELS = ("gf_matmul_cols_batched",)
OPS_KERNELS = ("gf_matmul", "gf_delta_update", "gf_cuckoo_probe")
# seal folds, sealed-update deltas and recovery decodes
SHARDED_KERNELS = ("gf_per_item_fold", "gf_delta_apply_batched",
                   "gf_matmul_batched")


def launched_in(torch, fn):
    """Run ``fn`` with every launch count at 0 (and the ``ShapeLog`` in
    force counting); return its result and the counts it left (read after
    the card has finished)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    shape_log = SHAPE_LOG
    reset_launch_counts()
    if shape_log:
        shape_log.active = True
    try:
        out = fn()
    finally:
        if shape_log:
            shape_log.active = False
    torch.cuda.synchronize()
    return out, launch_counts()


def twin_process():
    """One spawned worker process for a numpy-engine twin, which then runs
    beside the CUDA cluster on its own cores: both are host-bound Python,
    and one after the other they took ~600 of a 1,312 s run on an H100
    80GB HBM3 at 700 W's host (PERF.md §6, PR 26)."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))


def twin_run(testbed, kind: str) -> dict:
    """In the twin's process: ``testbed``'s scenario ("cluster":
    ``scenario`` at ``OBJECTS``, "sharded": ``sharded_scenario`` at
    ``SHARDED_OBJECTS``) on the numpy engine, and what the CUDA cluster
    is held to: its transitions (the sharded reports), counts, stats and
    contents, with its seconds per phase and wall seconds."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.memec import make_configured_cluster
    from repro_torch.data.ycsb import YCSBConfig, run_workload
    n = OBJECTS if kind == "cluster" else SHARDED_OBJECTS
    cfg = YCSBConfig(num_objects=n, key_size=testbed.key_size,
                     value_sizes=testbed.value_sizes)
    twin = make_configured_cluster(testbed, engine="numpy")
    t0 = time.perf_counter()
    if kind == "cluster":
        trans, secs, counts, _ = scenario(twin, cfg, run_workload)
        inserted = OPS["parity_down"]
    else:
        trans, secs, counts = sharded_scenario(twin, cfg, run_workload,
                                               testbed.batch_size)
        inserted = 0
    wall = time.perf_counter() - t0
    return dict(trans=trans, secs=secs, counts=counts, stats=twin.stats,
                contents=contents(twin, cfg, inserted), wall=wall)


def run_cluster(np, torch, testbed, must_launch):
    """The testbed scenario on the CUDA engine against a numpy-engine
    twin; ``must_launch`` names the kernels the scenario has to launch.
    Returns the launches per kernel and the CUDA cluster."""
    from repro_torch.configs.memec import make_configured_cluster
    from repro_torch.data.ycsb import YCSBConfig, run_workload

    cfg = YCSBConfig(num_objects=OBJECTS, key_size=testbed.key_size,
                     value_sizes=testbed.value_sizes)
    cl = make_configured_cluster(testbed, engine="cuda")
    tag = f"{testbed.scheme.upper()}({testbed.n},{testbed.k})"
    log(f"cluster {tag}: {testbed.num_servers} servers, "
        f"{testbed.num_proxies} proxies, c={testbed.c}, chunk "
        f"{testbed.chunk_size} B (r = {cl.engine.rep.r}), {OBJECTS} objects, "
        f"YCSB batch {BATCH}")
    with twin_process() as pool:
        pending = pool.submit(twin_run, testbed, "cluster")
        t0 = time.perf_counter()
        (trans, secs, counts, decodes), launches = launched_in(
            torch, lambda: scenario(cl, cfg, run_workload))
        wall = time.perf_counter() - t0
        twin = pending.result()
    log(f"cluster {tag} cuda seconds per phase:", json.dumps(secs))
    log(f"cluster {tag} cuda launches per kernel:", json.dumps(launches))
    log(f"cluster {tag} cuda engine:", json.dumps(cl.engine.stats()))
    log(f"cluster {tag} chunks:", json.dumps(counts))
    log(f"cluster {tag} numpy twin seconds per phase:",
        json.dumps(twin["secs"]))
    log(f"cluster {tag} scenario wall seconds: cuda {wall:.3f}, numpy twin "
        f"{twin['wall']:.3f} (in a process of its own, beside)")
    log(f"cluster {tag} fail_server decodes replayed (host s per engine):",
        json.dumps(replay_decodes(np, torch, cl.code, decodes)))

    missing = [k for k in must_launch if launches[k] == 0]
    assert not missing, f"{tag}: kernels never launched: {missing}"
    paths = set(cl.engine.op_paths.values())
    assert paths == {"cuda-kernel"}, f"op_paths {cl.engine.op_paths}"
    if cl.engine.rep.r != 1:
        assert "delta" not in cl.engine.op_paths, cl.engine.op_paths
    assert counts["sealed_after_load_A"] > 0, "no chunk sealed"
    assert counts["recovered_chunks"]["fail_data"] > 0, "nothing recovered"
    assert trans == twin["trans"], "fail/restore transitions differ"
    assert counts == twin["counts"], (counts, twin["counts"])
    assert cl.stats == twin["stats"], "cluster stats differ from the twin"
    got = contents(cl, cfg, OPS["parity_down"])
    assert got == twin["contents"], "contents differ from the numpy twin"
    assert all(v is not None for v in got[:OBJECTS]), "a loaded key is lost"
    checked, bad = parity_invariant(np, cl)
    log(f"cluster {tag} parity sweep: {checked} sealed data chunks checked, "
        f"{bad} bad")
    assert checked > 0 and bad == 0
    return launches, cl


def check_probe_on_index(np, torch, cl, row):
    """Kernel 10 on a real object index: the server of the loaded testbed
    holding the most keys, probed for all its resident keys plus as many
    absent ones, against the plain version and the index itself; then the
    keys-in time of ``ops.batched_index_lookup`` (host hashing, the table
    copied to the card) beside the arrays-in time of the kernel row."""
    from repro_torch.kernels import ops
    srv = max(cl.servers, key=lambda s: s.object_index.size)
    index = srv.object_index
    resident = index.keys()
    absent = [b"absent-key-%013d" % i for i in range(len(resident))]
    keys = resident + absent
    found, slot = ops.batched_index_lookup(index, keys)
    pf, ps = ops.batched_index_lookup(index, keys, device="cpu")
    torch.cuda.synchronize()
    assert torch.equal(found.cpu(), pf) and torch.equal(slot.cpu(), ps), \
        "probe on the testbed index differs from the plain version"
    assert found.cpu().numpy().tolist() == \
        [True] * len(resident) + [False] * len(absent)
    for key, s in zip(resident, slot.cpu().numpy()):
        b, sl = divmod(int(s), 4)
        assert index.slot_data[(b, sl)][0] == key
    row["checked"].append(
        f"testbed server {srv.sid} object index: {index.num_buckets} "
        f"buckets, {len(resident)} resident + {len(absent)} absent keys")
    keys_in = {}
    for q, reps in ((64, 50), (len(keys), 3)):
        probe = keys[:q]
        t0 = time.perf_counter()
        for _ in range(reps):
            ops.batched_index_lookup(index, probe)
        torch.cuda.synchronize()
        keys_in[f"keys_in_ms_q{q}"] = (time.perf_counter() - t0) / reps * 1e3
    row["keys_in"] = dict(keys_in, buckets=index.num_buckets)
    log(f"kernel gf_cuckoo_probe on the testbed index of server {srv.sid} "
        f"({index.num_buckets} buckets, {len(keys)} keys): equal to the "
        f"plain version; keys-in host ms per ops.batched_index_lookup: "
        f"{json.dumps(keys_in)}")


def run_wide_decode(np, torch):
    """RS(14,10) (f4's warm BLOB code) through ``CudaEngine``: one decode
    of 200 stripes of 4 KB chunks (about a ``fail_server`` recovery batch
    of the testbed) whose patterns re-encode three or four parities, so
    the fused matrices are (13, 10) and (14, 10) and take the column-loop
    kernel.  Held against ``NumpyEngine``."""
    stripes, C = 200, 4096
    from repro_torch.core.codes import make_code
    from repro_torch.core.engine import CudaEngine, NumpyEngine
    code = make_code("rs", 14, 10)
    rng = np.random.default_rng(1410)
    data = rng.integers(0, 256, (stripes, 10, C), dtype=np.uint8)
    ref = NumpyEngine(code)
    par = ref.encode_batch(data)
    patterns = [((0,), (0, 10, 11, 12)), ((1, 2), (1, 2, 10, 11, 12, 13)),
                ((10, 11, 12), (10, 11, 12)), ((10, 11, 12, 13),
                                               (10, 11, 12, 13))]
    avail, wanted = [], []
    for b in range(stripes):
        lost, want = patterns[b % len(patterns)]
        stripe = np.concatenate([data[b], par[b]])
        avail.append({p: stripe[p] for p in range(14) if p not in lost})
        wanted.append(list(want))
    eng = CudaEngine(code)
    t0 = time.perf_counter()
    got, launches = launched_in(
        torch, lambda: eng.submit_decode(avail, wanted, C).result())
    cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ref.decode_batch(avail, wanted, C)
    numpy_s = time.perf_counter() - t0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(
            np.array_equal(g[p], w[p]) for p in w), "RS(14,10) decode differs"
    shapes = sorted({M.shape for M in eng._fused_cache.values()})
    log(f"RS(14,10) decode of {stripes} stripes x {C} B, fused matrices "
        f"{shapes}: cuda {cuda_s:.4f} s, numpy {numpy_s:.4f} s (host s); "
        f"launches {json.dumps(launches)}")
    missing = [k for k in COLS_KERNELS if launches[k] == 0]
    assert not missing, f"RS(14,10) decode never launched {missing}"
    assert set(eng.op_paths.values()) == {"cuda-kernel"}, eng.op_paths
    return launches


def run_ops(np, torch):
    """The public entry points of ``repro_torch.kernels.ops`` on RS(10,8)
    4 KB chunks - encode, decode of two lost positions, a parity delta,
    an index probe - held against ``core.codes`` and the index, then the
    port's quickstart on the card (its own asserts must hold).  Kernels
    8-10 must launch."""
    from repro_torch import quickstart
    from repro_torch.core.codes import RSCode
    from repro_torch.core.index import CuckooIndex
    from repro_torch.kernels import ops
    code = RSCode(n=10, k=8)
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (8, 4096), dtype=np.uint8)
    new3 = data[3].copy()
    new3[100:900] = rng.integers(0, 256, 800, dtype=np.uint8)
    index = CuckooIndex(num_buckets=1 << 12)
    keys = [b"user%020d" % i for i in range(8000)]
    for i, key in enumerate(keys):
        index.insert(key, i)
    probe = keys[::2] + [b"none%020d" % i for i in range(4000)]

    def drive():
        d = torch.from_numpy(data).cuda()
        par = ops.encode_stripe(code, d)
        stripe = torch.cat([d, par])
        lost = (2, 9)
        rec = ops.decode_stripe(code, {i: stripe[i] for i in range(10)
                                       if i not in lost}, list(lost), 4096)
        upd = ops.apply_parity_delta(code, par, 3, d[3],
                                     torch.from_numpy(new3).cuda())
        found, slot = ops.batched_index_lookup(index, probe)
        quickstart.main([])
        return [x.cpu().numpy() for x in (par, rec[2], rec[9], upd, found,
                                          slot)]
    t0 = time.perf_counter()
    (par, rec2, rec9, upd, found, slot), launches = launched_in(torch, drive)
    secs = time.perf_counter() - t0
    want_par = code.encode(data)
    assert np.array_equal(par, want_par), "ops.encode_stripe differs"
    assert np.array_equal(rec2, data[2]) and np.array_equal(rec9, want_par[1])
    d2 = data.copy()
    d2[3] = new3
    assert np.array_equal(upd, code.encode(d2)), "apply_parity_delta differs"
    assert found.tolist() == [key in index for key in probe]
    for key, f, s in zip(probe, found, slot):
        if f:
            assert index.slot_data[divmod(int(s), 4)][0] == key
    log(f"phase ops (entry points + quickstart on the card): {secs:.1f} s; "
        f"launches {json.dumps(launches)}")
    missing = [k for k in OPS_KERNELS if launches[k] == 0]
    assert not missing, f"ops phase never launched {missing}"
    return launches


def sharded_scenario(cl, cfg, run_workload, batch: int):
    """load -> A -> fail a data server in the shard with the most sealed
    chunks -> A -> restore -> add_shard (live migration) -> A hammering
    shard 0 -> rebalance (at most ``REBALANCE_MOVES`` keys).  Returns
    (reports, seconds per phase, counts)."""
    secs, reports = {}, []

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    phase("load", lambda: run_workload(cl, "load", 0, cfg, batch_size=batch))
    phase("A", lambda: run_workload(cl, "A", SHARDED_OPS["A"], cfg,
                                    batch_size=batch))
    sealed = [sealed_chunks(sh) for sh in cl.shards]
    counts = {"sealed_per_shard_after_load_A": sealed}
    si = max(range(len(sealed)), key=lambda i: sealed[i])
    sid = victim(cl.shards[si], False)
    reports.append(("fail", si, sid, phase(
        "fail", lambda: cl.fail_server(sid, shard=si))))
    phase("A_degraded", lambda: run_workload(
        cl, "A", SHARDED_OPS["degraded"], cfg, batch_size=batch))
    reports.append(("restore", si, sid, phase(
        "restore", lambda: cl.restore_server(sid, shard=si))))
    reports.append(("add_shard", phase(
        "add_shard", lambda: cl.add_shard(batch_size=batch))))
    cl.reset_load()
    phase("A_hot_shard0", lambda: run_workload(
        cl, "A", SHARDED_OPS["hot"], cfg, batch_size=batch, hot_shard=0))
    reports.append(("rebalance", phase(
        "rebalance", lambda: cl.rebalance(skew_threshold=1.2,
                                          max_moves=REBALANCE_MOVES,
                                          batch_size=batch))))
    counts["sealed_per_shard_end"] = [sealed_chunks(sh) for sh in cl.shards]
    return reports, secs, counts


def run_sharded(np, torch, testbed):
    """Four paper testbeds as the shards of one ring-placed cluster on the
    card (each shard its own ``CudaEngine``; the scatter runs them on
    worker threads), against a numpy-engine twin."""
    from repro_torch.configs.memec import make_configured_cluster
    from repro_torch.data.ycsb import YCSBConfig, run_workload
    cfg = YCSBConfig(num_objects=SHARDED_OBJECTS, key_size=testbed.key_size,
                     value_sizes=testbed.value_sizes)
    cl = make_configured_cluster(testbed, engine="cuda")
    log(f"sharded: {testbed.shards} shards x ({testbed.num_servers} servers, "
        f"RS({testbed.n},{testbed.k}), c={testbed.c}, {testbed.chunk_size} B "
        f"chunks), placement {testbed.placement}, {SHARDED_OBJECTS} objects, "
        f"YCSB batch {testbed.batch_size}")
    with twin_process() as pool:
        pending = pool.submit(twin_run, testbed, "sharded")
        t0 = time.perf_counter()
        (reports, secs, counts), launches = launched_in(
            torch, lambda: sharded_scenario(cl, cfg, run_workload,
                                            testbed.batch_size))
        wall = time.perf_counter() - t0
        twin = pending.result()
    log("sharded cuda seconds per phase:", json.dumps(secs))
    log("sharded cuda launches per kernel:", json.dumps(launches))
    log("sharded chunks:", json.dumps(counts))
    log("sharded numpy twin seconds per phase:", json.dumps(twin["secs"]))
    log(f"sharded scenario wall seconds: cuda {wall:.3f}, numpy twin "
        f"{twin['wall']:.3f} (in a process of its own, beside)")
    log("sharded reports:", json.dumps(reports, default=str))

    missing = [k for k in SHARDED_KERNELS if launches[k] == 0]
    assert not missing, f"sharded: kernels never launched: {missing}"
    assert all(n > 0 for n in counts["sealed_per_shard_after_load_A"]), \
        f"a shard sealed nothing: {counts}"
    assert reports[0][3]["recovered_chunks"] > 0, "nothing recovered"
    assert reports[2][1]["moved_keys"] > 0, "add_shard moved nothing"
    assert reports[3][1]["moved_keys"] > 0, f"rebalance: {reports[3][1]}"
    for i, eng in enumerate(cl.engines):
        paths = set(eng.op_paths.values())
        assert paths <= {"cuda-kernel"}, f"shard {i} op_paths {eng.op_paths}"
        assert paths or i >= testbed.shards, f"shard {i} ran no coding op"
    assert reports == twin["trans"], "fail/restore/migration reports differ"
    assert counts == twin["counts"], (counts, twin["counts"])
    assert cl.stats == twin["stats"], "sharded stats differ from the twin"
    got = contents(cl, cfg, 0)
    assert got == twin["contents"], "contents differ from the twin"
    assert all(v is not None for v in got), "a loaded key is lost"
    for i, sh in enumerate(cl.shards):
        checked, bad = parity_invariant(np, sh)
        log(f"sharded shard {i} parity sweep: {checked} sealed data chunks "
            f"checked, {bad} bad")
        assert bad == 0
    return launches


# the model phase: starcoder2-3b at full width, cut against the
# reference's prefill_32k cell (batch 32 -> 4, seq 32,768 -> 2,048: at full
# size the bf16 logits alone would take 103 GB)
MODEL_ARCH = "starcoder2-3b"
PREFILL_BATCH, PREFILL_SEQ = 4, 2048
DECODE_POSITIONS = 128
# Logit bounds.  fp32: decode_step against apply on a twin of the model
# with the same weights; the two sum in different orders through 30
# layers (1.1e-4 read on an H100, against logits of magnitude ~6).  bf16:
# bf16 decode against bf16 prefill, and each of them against the fp32
# twin's own path; random weights carry bf16 rounding through every layer.
# Sound readings on an H100 80GB HBM3 at 700 W: 0.316 (decode vs
# prefill), 0.332 (decode vs fp32 decode), 0.393 (prefill vs fp32 prefill
# over all 4 x 2,048 positions).  A kernel that is wrong in the last Q
# tile alone - each of its rows skips its own key - read 1.82 against the
# fp32 prefill; the script runs that control each time and it must fail.
FP32_LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 0.75


def faulted_attention(torch, fa):
    """A control: kernel 11 whose last 64 query rows miss their own key
    (the diagonal off by one in the last Q tile).  Those rows are
    recomputed by plain torch with the faulty mask."""
    import math

    def attention(q, k, v, *, causal=True, block_q=128, block_kv=128,
                  stripe=None):
        assert stripe is None, "the control fault is for unstriped calls"
        out = fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                 block_kv=block_kv)
        S, H, hd = q.shape[1], q.shape[2], q.shape[3]
        r0 = S - 64
        idx = torch.arange(H, device=q.device) // (H // k.shape[2])
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:].float(),
                         k[:, :, idx].float()) / math.sqrt(hd)
        i = torch.arange(r0, S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(~(j < i), fa.NEG_INF)
        out[:, r0:] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                                   v[:, :, idx].float()).to(q.dtype)
        return out
    return attention


def checked_attention(torch, fa, inner, ratios):
    """Kernel 11 (or ``inner``, a control) held per call against its plain
    version on the inputs the model gives it: each call's worst
    |got - want| / ``tolerance`` goes into ``ratios``."""
    def attention(q, k, v, *, causal=True, block_q=128, block_kv=128,
                  stripe=None):
        out = inner(q, k, v, causal=causal, block_q=block_q,
                    block_kv=block_kv, stripe=stripe)
        ratios.append(fa.tolerance_ratio(out, fa.flash_attention_plain(
            q, k, v, causal=causal, stripe=stripe)))
        return out
    return attention


def logit_err(torch, got, want):
    """Max |got - want| over the (B, P, V) logits, compared in fp32."""
    return float(max((g.float() - w.float()).abs().max()
                     for g, w in zip(got, want)))


def run_model(np, torch, dev, card):
    """starcoder2-3b on the card: (a) the prefill step ``Model.apply`` on
    4 x 2,048 tokens, which must launch kernel 11 once per layer and no
    other kernel, held against an fp32 twin with the same weights whose
    ``apply`` runs the fp32 kernel at the same length; (b) ``decode_step``
    over the first 128 positions of the same prompts, held against (a)
    and against the twin's decode; a control (kernel 11 faulted in its
    last Q tile) must fail (a)'s check; (c) the serving launcher at its
    defaults.  Returns the launches of (a), of (b) + (c) in bf16, and the
    phase's numbers."""
    import contextlib
    import io

    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg = get_config(MODEL_ARCH)
    P = DECODE_POSITIONS
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; {n_params} parameters "
        f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card), "
        f"init {time.perf_counter() - t0:.2f} s")
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                         generator=gen, device=dev)
    batch = {"tokens": toks}

    # (a) prefill: one warm-up call, then the counted, timed one
    model.apply(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits, prefill_launches = launched_in(torch, lambda: model.apply(batch))
    prefill_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    assert logits.shape == (PREFILL_BATCH, PREFILL_SEQ, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    log(f"model prefill Model.apply {PREFILL_BATCH}x{PREFILL_SEQ}: "
        f"{prefill_s:.4f} s ({PREFILL_BATCH * PREFILL_SEQ / prefill_s:.1f} "
        f"tok/s), peak {peak_gb:.2f} GB; launches "
        f"{json.dumps(prefill_launches)}")
    assert prefill_launches["flash_attention"] == cfg.num_layers, \
        prefill_launches
    others = {k: n for k, n in prefill_launches.items()
              if k != "flash_attention" and n}
    assert not others, f"prefill launched other kernels: {others}"

    # the fp32 twin: the same weights, cast exactly; its prefill runs the
    # fp32 kernel at the main path's length
    twin = Model(cfg.scaled(dtype="float32"), device=dev)
    twin.load_state_dict(model.state_dict())
    want32, twin_launches = launched_in(torch, lambda: twin.apply(batch))
    assert twin_launches["flash_attention"] == cfg.num_layers, twin_launches
    prefill_err = logit_err(torch, logits, want32)

    # the control: a kernel wrong in its last Q tile must fail that check
    real = layers.flash_attention
    layers.flash_attention = faulted_attention(torch, fa)
    try:
        control = model.apply(batch)
    finally:
        layers.flash_attention = real
    control_err = logit_err(torch, control, want32)
    del control

    def decode(m, dtype):
        """(B, P, V) fp32 logits of P decode steps, and seconds per step."""
        cache = m.init_cache(PREFILL_BATCH, P, dtype=dtype)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(P):
            out, cache = m.decode_step(cache, toks[:, t], t)
            outs.append(out.float())
        torch.cuda.synchronize()
        return torch.stack(outs, dim=1), (time.perf_counter() - t0) / P

    # (b) bf16 decode, as served (bf16 cache), and the twin's in fp32
    (got, step_s), decode_launches = launched_in(
        torch, lambda: decode(model, torch.bfloat16))
    got32, step32_s = decode(twin, torch.float32)
    del twin
    want = logits[:, :P]
    err32 = logit_err(torch, got32, want32[:, :P])
    err = (got - want.float()).abs().amax(dim=(0, 2))
    decode_vs_fp32 = logit_err(torch, got, got32)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    dec = dict(decode_ms_per_step=step_s * 1e3,
               decode32_ms_per_step=step32_s * 1e3,
               fp32_decode_vs_prefill=err32, fp32_tolerance=FP32_LOGIT_TOL,
               bf16_decode_vs_prefill=float(err.max()),
               bf16_worst_position=int(err.argmax()),
               bf16_decode_vs_fp32_decode=decode_vs_fp32,
               bf16_prefill_vs_fp32_prefill=prefill_err,
               bf16_tolerance=BF16_LOGIT_TOL,
               control_vs_fp32_prefill=control_err,
               max_abs_logit=float(want32.abs().max()), argmax_agree=agree)
    del logits, want32, got, got32, want
    torch.cuda.empty_cache()
    log(f"model logits (max abs, fp32 compare; max |logit| "
        f"{dec['max_abs_logit']}): bf16 prefill vs fp32 twin prefill "
        f"{prefill_err} over {PREFILL_BATCH}x{PREFILL_SEQ}; bf16 decode_step "
        f"x {P} vs bf16 prefill {dec['bf16_decode_vs_prefill']} at position "
        f"{dec['bf16_worst_position']}, vs fp32 twin decode "
        f"{decode_vs_fp32} (bf16 tolerance {BF16_LOGIT_TOL}); fp32 twin "
        f"decode vs its prefill {err32} (tolerance {FP32_LOGIT_TOL}); "
        f"control (last Q tile skips its own key) vs fp32 prefill "
        f"{control_err}, must exceed {BF16_LOGIT_TOL}; argmax agrees at "
        f"{agree:.4f} of positions; decode {step_s * 1e3:.2f} ms/step bf16, "
        f"{step32_s * 1e3:.2f} fp32")
    assert err32 <= FP32_LOGIT_TOL, (err32, FP32_LOGIT_TOL)
    for name in ("bf16_prefill_vs_fp32_prefill", "bf16_decode_vs_prefill",
                 "bf16_decode_vs_fp32_decode"):
        assert dec[name] <= BF16_LOGIT_TOL, (name, dec[name], BF16_LOGIT_TOL)
    assert control_err > BF16_LOGIT_TOL, \
        f"the faulted control passes the bf16 check: {control_err}"

    assert not any(decode_launches.values()), \
        f"decode launched kernels: {decode_launches}"

    # (c) the launcher at the reference launcher's defaults, with the KV
    # cache pages EC-protected: it refreshes their parity after the
    # decode, rebuilds data position 0's pages from it and prints whether
    # they equal the live cache pages
    def run_serve():
        out_txt = io.StringIO()
        with contextlib.redirect_stdout(out_txt):
            serve.main(["--arch", MODEL_ARCH, "--batch", "4", "--prompt-len",
                        "32", "--gen", "32", "--protect"])
        return out_txt.getvalue().splitlines()

    lines, serve_launches = launched_in(torch, run_serve)
    for line in lines:
        log(f"launch.serve --protect: {line}")
    assert any("tok/s" in line for line in lines), lines
    recovered = [line for line in lines if "equal the live cache" in line]
    log(f"launch.serve --protect [{card}]: {recovered}; launches "
        f"{json.dumps(serve_launches)}")
    assert len(recovered) == 1 and recovered[0].endswith(
        "equal the live cache: True"), \
        f"the recovered cache pages differ from the live cache: {lines}"
    assert serve_launches["gf_matmul_batched"] > 0, serve_launches
    others = {k: n for k, n in serve_launches.items()
              if k != "gf_matmul_batched" and n}
    assert not others, f"launch.serve launched other kernels: {others}"
    log(f"phase model: {time.perf_counter() - t_phase:.1f} s")
    return prefill_launches, decode_launches, serve_launches, dict(
        prefill_s=prefill_s, peak_gb=peak_gb, **dec)


# the hybrid phase: recurrentgemma-2b at full width (26 layers, 8 x "RRW"
# + "RR", d_model 2,560, 10 / 1 heads of 256, window 2,048, vocab
# 256,000, bf16): a prefill of 4 x 2,048 (no longer than the window, so
# each W layer's attention is one unmasked causal call of kernel 11 at hd
# 256), a prefill of 2 x 4,096 (windowed: the masked torch route, no
# kernel), decode over the first 128 positions, and serve --protect
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_LONG = (2, 4096)


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def run_hybrid(np, torch, dev, card):
    """recurrentgemma-2b on the card, checked as ``run_model`` checks
    starcoder2-3b: (a) ``Model.apply`` on 4 x 2,048 tokens launches kernel
    11 once per W layer and nothing else, held against an fp32 twin of the
    same weights within ``BF16_LOGIT_TOL``, and each of its kernel-11 calls
    against the plain version on the same inputs within the kernel's
    tolerance; a control (kernel 11 faulted in its last Q tile) must miss
    that per-call check (its logits move less than the bf16 noise: 8 of
    26 layers attend and the softcap of 30 bounds the logits); (b) ``Model.apply`` on 2 x 4,096
    tokens, longer than the window: every W layer takes the windowed
    torch route and kernel 11 is not launched; finite logits; (c)
    ``decode_step`` over the first 128 positions against (a) (bf16 within
    ``BF16_LOGIT_TOL``, the twin's within ``FP32_LOGIT_TOL``); (d)
    ``launch.serve --arch recurrentgemma-2b --protect`` at its defaults:
    the rebuilt pages of the W ring and the recurrent states equal the
    live ones.  Returns the launches of (a), (b), (c) and (d), and the
    phase's numbers."""
    import contextlib
    import io

    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg = get_config(HYBRID_ARCH)
    n_w = cfg.layers.count("W")
    P = DECODE_POSITIONS
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"hybrid {cfg.name}: {cfg.num_layers} layers ({cfg.layers}), "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} "
        f"KV, head_dim {cfg.head_dim}, window {cfg.local_window}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {n_params} parameters "
        f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB on the card), "
        f"init {time.perf_counter() - t0:.2f} s")
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                         generator=gen, device=dev)
    batch = {"tokens": toks}

    # (a) prefill within the window: one warm-up, then counted and timed
    model.apply(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    layers.reset_op_paths()
    t0 = time.perf_counter()
    logits, prefill_launches = launched_in(torch, lambda: model.apply(batch))
    prefill_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    routes = dict(layers.OP_PATHS)
    assert logits.shape == (PREFILL_BATCH, PREFILL_SEQ, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    log(f"hybrid prefill Model.apply {PREFILL_BATCH}x{PREFILL_SEQ}: "
        f"{prefill_s:.4f} s ({PREFILL_BATCH * PREFILL_SEQ / prefill_s:.1f} "
        f"tok/s), peak {peak_gb:.2f} GB; routes {routes}; launches "
        f"{json.dumps(prefill_launches)}")
    assert prefill_launches["flash_attention"] == n_w, prefill_launches
    assert routes == {"flash_attention:cuda-kernel": n_w}, routes
    others = {k: n for k, n in prefill_launches.items()
              if k != "flash_attention" and n}
    assert not others, f"prefill launched other kernels: {others}"

    twin = Model(cfg.scaled(dtype="float32"), device=dev)
    twin.load_state_dict(model.state_dict())
    want32, twin_launches = launched_in(torch, lambda: twin.apply(batch))
    assert twin_launches["flash_attention"] == n_w, twin_launches
    prefill_err = logit_err(torch, logits, want32)

    # every kernel-11 call of the prefill against its plain version on
    # the same inputs (the logits alone cannot see a fault in the last Q
    # tile here: 8 of 26 layers attend, and the softcap bounds the
    # logits), then the control: the faulted kernel must miss that check
    real = layers.flash_attention
    call_ratios, control_ratios = [], []
    try:
        layers.flash_attention = checked_attention(torch, fa, real,
                                                   call_ratios)
        model.apply(batch)
        layers.flash_attention = checked_attention(
            torch, fa, faulted_attention(torch, fa), control_ratios)
        control = model.apply(batch)
    finally:
        layers.flash_attention = real
    control_err = logit_err(torch, control, want32)
    del control
    _free(torch)
    log(f"hybrid kernel 11 per call vs its plain version at the prefill's "
        f"inputs (ratio to the tolerance, <= 1): {call_ratios}; faulted "
        f"control (must exceed 1): {control_ratios}")
    assert len(call_ratios) == n_w and max(call_ratios) <= 1.0, call_ratios
    assert len(control_ratios) == n_w and min(control_ratios) > 1.0, \
        control_ratios

    # (b) longer than the window: the windowed route, no kernel
    B2, S2 = HYBRID_LONG
    long_toks = torch.randint(0, cfg.vocab_size, (B2, S2), generator=gen,
                              device=dev)
    layers.reset_op_paths()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    long_logits, long_launches = launched_in(
        torch, lambda: model.apply({"tokens": long_toks}))
    long_s = time.perf_counter() - t0
    long_routes = dict(layers.OP_PATHS)
    assert bool(torch.isfinite(long_logits).all()), "non-finite logits"
    del long_logits
    _free(torch)
    log(f"hybrid windowed prefill {B2}x{S2}: {long_s:.4f} s; routes "
        f"{long_routes}; launches {json.dumps(long_launches)}")
    assert not any(long_launches.values()), long_launches
    assert long_routes == {"masked_blockwise:torch": n_w}, long_routes

    def decode(m, dtype):
        cache = m.init_cache(PREFILL_BATCH, P, dtype=dtype)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(P):
            out, cache = m.decode_step(cache, toks[:, t], t)
            outs.append(out.float())
        torch.cuda.synchronize()
        return torch.stack(outs, dim=1), (time.perf_counter() - t0) / P

    # (c) decode, bf16 cache as served, and the twin's in fp32
    (got, step_s), decode_launches = launched_in(
        torch, lambda: decode(model, torch.bfloat16))
    got32, step32_s = decode(twin, torch.float32)
    del twin
    want = logits[:, :P]
    err32 = logit_err(torch, got32, want32[:, :P])
    dec_err = logit_err(torch, got, want)
    decode_vs_fp32 = logit_err(torch, got, got32)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    nums = dict(prefill_s=prefill_s, peak_gb=peak_gb, windowed_prefill_s=long_s,
                kernel11_call_ratios=call_ratios,
                control_call_ratios=control_ratios,
                decode_ms_per_step=step_s * 1e3,
                decode32_ms_per_step=step32_s * 1e3,
                fp32_decode_vs_prefill=err32,
                bf16_decode_vs_prefill=dec_err,
                bf16_decode_vs_fp32_decode=decode_vs_fp32,
                bf16_prefill_vs_fp32_prefill=prefill_err,
                control_vs_fp32_prefill=control_err,
                max_abs_logit=float(want32.abs().max()), argmax_agree=agree)
    del logits, want32, got, got32, want
    _free(torch)
    log(f"hybrid logits [{card}]: bf16 prefill vs fp32 twin {prefill_err}; "
        f"bf16 decode x {P} vs bf16 prefill {dec_err}, vs fp32 twin decode "
        f"{decode_vs_fp32} (bf16 tolerance {BF16_LOGIT_TOL}); fp32 twin "
        f"decode vs its prefill {err32} (tolerance {FP32_LOGIT_TOL}); "
        f"control vs fp32 prefill {control_err} (exceeding "
        f"{BF16_LOGIT_TOL} is not asked of it (the per-call check above "
        f"is); argmax agrees at {agree:.4f}; decode "
        f"{step_s * 1e3:.2f} ms/step bf16, {step32_s * 1e3:.2f} fp32")
    assert err32 <= FP32_LOGIT_TOL, (err32, FP32_LOGIT_TOL)
    for name in ("bf16_prefill_vs_fp32_prefill", "bf16_decode_vs_prefill",
                 "bf16_decode_vs_fp32_decode"):
        assert nums[name] <= BF16_LOGIT_TOL, (name, nums[name])
    assert not any(decode_launches.values()), decode_launches
    del model
    _free(torch)

    # (d) the launcher at its defaults with --protect
    def run_serve():
        out_txt = io.StringIO()
        with contextlib.redirect_stdout(out_txt):
            serve.main(["--arch", HYBRID_ARCH, "--protect"])
        return out_txt.getvalue().splitlines()

    lines, serve_launches = launched_in(torch, run_serve)
    for line in lines:
        log(f"launch.serve --arch {HYBRID_ARCH} --protect: {line}")
    recovered = [line for line in lines if "equal the live cache" in line]
    assert len(recovered) == 1 and recovered[0].endswith(
        "equal the live cache: True"), lines
    assert serve_launches["gf_matmul_batched"] > 0, serve_launches
    others = {k: n for k, n in serve_launches.items()
              if k != "gf_matmul_batched" and n}
    assert not others, f"launch.serve launched other kernels: {others}"
    _free(torch)
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"phase hybrid: {nums['phase_s']:.1f} s; kernel 11 launches: "
        f"prefill {prefill_launches['flash_attention']}, windowed "
        f"{long_launches['flash_attention']}, decode "
        f"{decode_launches['flash_attention']}")
    return (prefill_launches, long_launches, decode_launches,
            serve_launches, nums)


# the families phase: each other config once at full width, depth cut to
# fit one card and the time limit; (arch, layers kept, prefill batch,
# prefill length): mamba2-370m's length is one SSD chunk; the MoE configs
# take 4 tokens a row, at most the capacity of 4 each expert has at that
# length, so no assignment can drop (random weights route most tokens of
# a row to a few experts: at 8 tokens a row llama4-maverick dropped 1 of
# 16 assignments on an H100, at 16 kimi-k2 5 of 256)
FAMILIES = [("qwen2-vl-7b", 2, 2, 256), ("musicgen-medium", 2, 2, 256),
            ("minicpm3-4b", 2, 2, 256), ("mamba2-370m", 2, 2, 256),
            ("llama4-maverick-400b-a17b", 1, 2, 4),
            ("kimi-k2-1t-a32b", 1, 2, 4)]
#: decode steps held against the prefill, at most the prefill's length
FAMILY_DECODE_STEPS = 8


def run_families(np, torch, dev, card):
    """Each config of ``FAMILIES`` at full width with its depth cut: one
    ``Model.apply`` (embeddings for the audio and vision stubs), then
    ``decode_step`` over its first min(8, prefill length) positions
    against it within
    ``BF16_LOGIT_TOL``; kernel 11 launches once per attention layer in the
    prefill (none for MLA and Mamba-2), nothing in decode; the MoE
    configs drop no assignment.  Each model is freed before the next.
    Returns the summed launches of the prefills and of the decodes, and
    each config's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, moe
    from repro_torch.models.transformer import MIXER_KINDS
    t_phase = time.perf_counter()
    prefill_total, decode_total, nums = {}, {}, {}
    for arch, n_layers, Bf, Sf in FAMILIES:
        _free(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cfg = get_config(arch).scaled(num_layers=n_layers)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = Model(cfg, device=dev).init(gen)
        torch.cuda.synchronize()
        gb = torch.cuda.memory_allocated(dev) / 1e9
        steps = min(FAMILY_DECODE_STEPS, Sf)
        if cfg.input_mode == "embeddings":
            emb = torch.randn((Bf, Sf, cfg.d_model), generator=gen,
                              device=dev).to(torch.bfloat16)
            batch = {"embeddings": emb}
            step_in = [emb[:, t:t + 1] for t in range(steps)]
        else:
            toks = torch.randint(0, cfg.vocab_size, (Bf, Sf), generator=gen,
                                 device=dev)
            batch = {"tokens": toks}
            step_in = [toks[:, t] for t in range(steps)]
        moe.reset_drops()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, pl = launched_in(torch, lambda: model.apply(batch))
        prefill_s = time.perf_counter() - t1
        dropped, total = moe.dropped_assignments()
        assert bool(torch.isfinite(logits).all()), arch
        n_attn = sum(MIXER_KINDS[k] == "attn" for k in cfg.layers)
        assert pl["flash_attention"] == n_attn, (arch, pl)
        assert sum(pl.values()) == n_attn, (arch, pl)
        assert dropped == 0, f"{arch}: {dropped} of {total} dropped"
        # each kernel-11 call against its plain version on its inputs
        import repro_torch.models.layers as layers
        fa = importlib.import_module("repro_torch.kernels.flash_attention")
        real, ratios = layers.flash_attention, []
        layers.flash_attention = checked_attention(torch, fa, real, ratios)
        try:
            model.apply(batch)
        finally:
            layers.flash_attention = real
        assert len(ratios) == n_attn and max(ratios, default=0) <= 1, \
            (arch, ratios)

        def decode():
            cache = model.init_cache(Bf, steps)
            outs = []
            for t, x in enumerate(step_in):
                out, cache = model.decode_step(cache, x, t)
                outs.append(out.float())
            return torch.stack(outs, dim=1)

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, dl = launched_in(torch, decode)
        step_ms = (time.perf_counter() - t1) / steps * 1e3
        err = logit_err(torch, got, logits[:, :steps])
        assert not any(dl.values()), (arch, dl)
        for k, n in pl.items():
            prefill_total[k] = prefill_total.get(k, 0) + n
        for k, n in dl.items():
            decode_total[k] = decode_total.get(k, 0) + n
        nums[arch] = dict(layers=n_layers, prefill=f"{Bf}x{Sf}",
                          decode_steps=steps,
                          weights_gb=gb, prefill_s=prefill_s,
                          decode_ms_per_step=step_ms,
                          decode_vs_prefill=err,
                          flash_launches=pl["flash_attention"],
                          kernel11_call_ratios=ratios,
                          moe_dropped=dropped, moe_assignments=total,
                          peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                          seconds=time.perf_counter() - t0)
        log(f"family {arch} [{card}]: {json.dumps(nums[arch])}")
        assert err <= BF16_LOGIT_TOL, (arch, err, BF16_LOGIT_TOL)
        del model, logits, got, batch, step_in
    _free(torch)
    log(f"phase families: {time.perf_counter() - t_phase:.1f} s")
    return prefill_total, decode_total, nums


# the train phases: starcoder2-3b and recurrentgemma-2b at full width
# (remat "full"), B 2 x S 2048 from SyntheticLM(seed 0), AdamW as
# launch/train.py sets it, an ECCheckpoint RS(3,2) with 256-byte pages
# over a (data 4, model 1) mesh updated after every step
# (examples/train_ec_checkpoint.py's code)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
HYBRID_TRAIN_STEPS = 3
TRAIN_MESH = (4, 1)
TRAIN_EC = dict(k=2, m=1, page_size=256)
# Step 1 with kernel 11 (its forward, the torch backward) against the same
# step with the plain attention under autograd, both bf16 on the same
# weights and batch: the loss, the global gradient norm and, leaf by
# leaf, the attention weight gradients (wq, wk, wv, wo: relative
# Frobenius, the largest over the layers; a wrong dK or dV past the
# backward's first query tile moves wk and wv, which the norm barely
# sees).  The norm's and the gradients' bounds are TWIN_MULTIPLE times
# the distance, in this run and on these weights, of the plain bf16 step
# from the plain step of an fp32 twin (the same weights widened): if
# kernel 11's bf16 step is no further from the fp32 step than the plain
# one, the two are at most twice that apart.  scripts/gnorm_draws.py
# read five weight draws (seeds 0-4) of starcoder2-3b on an H100 80GB
# HBM3 (700 W): the fp32 pair's norms agree within 1.4e-7 and their
# gradients within 8.2e-6, so kernel 11 and the plain attention compute
# the same step; the bf16 pair's norms sit 5.1e-5 to 7.46e-4 apart
# (7.46e-4 at seed 2), 0.06 to 0.82 of the plain bf16 step's
# distance from the fp32 one (8.1e-4 to 1.29e-3, the bf16 norm lower in
# every draw), and their attention gradients 0.52 to 0.67 of it: bf16
# rounding, not a fault.  The loss keeps a fixed bound: its twin
# distance is a mean of signed roundings that nearly cancels in some
# draws (4.2e-4 at seed 4, 1.97e-3 at seed 1) and fell below the pair's
# own gap there (4.7e-4); the pair read 8.5e-5 to 4.7e-4 over the five
# (recurrentgemma-2b: a twin distance of 8.2e-5 against the pair's 4.4e-4).
TRAIN_LOSS_TOL = 2e-3
TWIN_MULTIPLE = 2
# launch.train at its reduced config on the card
TRAIN_LAUNCH_ARGS = ["--arch", MODEL_ARCH, "--reduced", "--steps", "20",
                     "--ec"]
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")


def plain_attention(fa):
    """Kernel 11's plain version, differentiated by autograd: the check's
    reference for step 1 alone, never the main path."""
    def attention(q, k, v, *, causal=True, block_q=128, block_kv=128,
                  stripe=None):
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        stripe=stripe)
    return attention


def first_tile_dk(fa):
    """The control's faulted attention backward: dK summed over the first
    query tile alone, as if later tiles' contributions were dropped."""
    real = fa.flash_attention_backward

    def backward(q, k, v, out, dout, *, causal=True, stripe=None):
        dq, _, dv = real(q, k, v, out, dout, causal=causal, stripe=stripe)
        t = slice(0, fa.BWD_BLOCK_Q)
        _, dk, _ = real(q[:, t], k, v, out[:, t], dout[:, t], causal=causal,
                        stripe=stripe)
        return dq, dk, dv
    return backward


def step1_grads(torch, model, batch, module, name, replacement,
                every=False):
    """Step 1's loss, global gradient norm and copies of the attention
    weight gradients of each layer that has attention (``every``: of
    every parameter, by name), with ``module.name`` replaced (None: as
    the port runs)."""
    from repro_torch.models.convert import param_tree
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    real = getattr(module, name)
    if replacement is not None:
        setattr(module, name, replacement)
    try:
        (loss, _), grads = value_and_grad(make_loss_fn(model),
                                          param_tree(model), batch)
        norm = float(global_norm(grads))
    finally:
        setattr(module, name, real)
    if every:
        attn = {n: t.grad.clone() for n, t in model.named_parameters()}
    else:
        attn = [{w: getattr(layer.attn, w).grad.clone()
                 for w in ATTN_WEIGHTS}
                for layer in model.layers if hasattr(layer, "attn")]
    del grads
    for t in model.parameters():
        t.grad = None
    return float(loss), norm, attn


def fp32_twin(torch, model):
    """A float32 copy of ``model`` with the same weights (bf16 values
    widened), on the same device."""
    from repro_torch.models import Model
    twin = Model(model.cfg.scaled(dtype="float32"), device=model.device)
    twin.load_state_dict(model.state_dict())
    return twin


def attn_grad_errors(got, want) -> dict:
    """Per weight name, the largest |g - g_ref| / |g_ref| over the
    layers."""
    return {w: max(float((g[w].float() - p[w].float()).norm()
                         / p[w].float().norm()) for g, p in zip(got, want))
            for w in ATTN_WEIGHTS}


def step1_checks(torch, model, batch, card, label) -> dict:
    """Step 1 of ``model`` on ``batch`` with the plain attention; kernel
    11's attention weight gradients against it and the faulted control's
    (dK of the first query tile alone), which must miss its bound; the
    plain step of an fp32 twin, from which the norm's and the gradients'
    bounds come (``TWIN_MULTIPLE``).  Returns the readings and the bounds; the
    caller holds its training step 1's loss and norm to them."""
    import repro_torch.models.layers as layers
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    plain_loss, plain_norm, plain_attn = step1_grads(
        torch, model, batch, layers, "flash_attention", plain_attention(fa))
    _, _, got = step1_grads(torch, model, batch, fa,
                            "flash_attention_backward", None)
    attn_err = attn_grad_errors(got, plain_attn)
    del got
    _, _, got = step1_grads(torch, model, batch, fa,
                            "flash_attention_backward", first_tile_dk(fa))
    control_err = attn_grad_errors(got, plain_attn)
    del got
    twin = fp32_twin(torch, model)
    twin_loss, twin_norm, twin_attn = step1_grads(
        torch, twin, batch, layers, "flash_attention", plain_attention(fa))
    del twin
    twin_attn_err = attn_grad_errors(plain_attn, twin_attn)
    del twin_attn, plain_attn
    _free(torch)
    bounds = dict(
        loss=TRAIN_LOSS_TOL,
        norm=TWIN_MULTIPLE * abs(plain_norm - twin_norm) / twin_norm,
        attn={w: TWIN_MULTIPLE * e for w, e in twin_attn_err.items()})
    nums = dict(plain_step1_loss=plain_loss, plain_step1_grad_norm=plain_norm,
                fp32_twin_step1_loss=twin_loss,
                fp32_twin_step1_grad_norm=twin_norm,
                twin_attn_grad_rel_err=twin_attn_err, bounds=bounds,
                step1_attn_grad_rel_err=attn_err,
                control_attn_grad_rel_err=control_err)
    log(f"{label} [{card}] step 1, plain bf16 vs its fp32 twin: loss "
        f"{plain_loss} vs {twin_loss}, grad norm {plain_norm} vs "
        f"{twin_norm}, attention weight gradients {json.dumps(twin_attn_err)}"
        f"; bounds ({TWIN_MULTIPLE} x the norm's and the gradients' gaps, "
        f"the loss's fixed): {json.dumps(bounds)}")
    log(f"{label} [{card}] step 1 attention weight gradients, kernel 11 vs "
        f"plain attention, max over layers of |g - g_plain| / |g_plain|: "
        f"{json.dumps(attn_err)}; control (dK of the first query tile "
        f"alone): {json.dumps(control_err)}, must exceed its bound")
    for w in ATTN_WEIGHTS:
        assert attn_err[w] <= bounds["attn"][w], (w, attn_err, bounds)
    assert any(control_err[w] > bounds["attn"][w] for w in ATTN_WEIGHTS), \
        f"the faulted backward passes the check: {control_err}"
    return nums


def check_step1(card, label, loss, norm, checks) -> dict:
    """Training step 1's loss and norm (kernel 11) against the plain
    attention's, within the twin-derived bounds of ``step1_checks``."""
    b = checks["bounds"]
    loss_err = abs(loss - checks["plain_step1_loss"])
    norm_err = abs(norm - checks["plain_step1_grad_norm"]) \
        / checks["plain_step1_grad_norm"]
    log(f"{label} [{card}] step 1 with kernel 11 vs plain attention: loss "
        f"{loss} vs {checks['plain_step1_loss']} (|diff| {loss_err}, bound "
        f"{b['loss']}); grad norm {norm} vs "
        f"{checks['plain_step1_grad_norm']} (relative {norm_err}, bound "
        f"{b['norm']})")
    assert loss_err <= b["loss"], (loss_err, b["loss"])
    assert norm_err <= b["norm"], (norm_err, b["norm"])
    return dict(step1_loss_err=loss_err, step1_grad_norm_rel_err=norm_err)


def train_with_ec(np, torch, dev, card, label, model, data, steps):
    """``steps`` AdamW steps of ``make_train_step`` with an ECCheckpoint
    (``TRAIN_EC`` over ``TRAIN_MESH``) updated after each, counted from
    launch counts at 0: per-step loss, norm and time, peak memory, the
    EC encode, a zero-delta update (its cost; the parity must not
    change), the parity against a fresh encode, every position rebuilt
    byte for byte and a flipped parity byte that must break a rebuild.
    Returns (the launches, the numbers, the live pages, the EC
    config)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.ecstore import ECConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import param_tree
    from repro_torch.train.checkpoint import ECCheckpoint
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    cfg = model.cfg
    params = param_tree(model)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    opt = make_optimizer("adamw", lr=1e-3,
                         warmup_steps=min(20, steps // 5 + 1),
                         total_steps=steps)
    opt_state = opt.init(params)
    mesh = make_mesh(TRAIN_MESH, ("data", "model"))
    ec_cfg = ECConfig(**TRAIN_EC)
    ec = ECCheckpoint(mesh, shd.param_specs(cfg, params, mesh), ec_cfg)
    step_fn = make_train_step(model, opt, ec=ec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    reset_launch_counts()
    t0 = time.perf_counter()
    ec.create(params)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    losses, norms, step_s = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt_state, _, metrics = step_fn(params, opt_state, data.batch(i))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        log(f"{label} [{card}] step {i}: loss {losses[-1]}, grad norm "
            f"{norms[-1]}, {step_s[-1]:.4f} s, "
            f"{tokens / step_s[-1]:.1f} tok/s")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # an update whose old and new bytes are equal: the cost of one EC
    # update (pack, pack-and-XOR, rotate, kernel 1, fold) at this state's
    # size, and the parity must not change
    before = ec.parity.clone()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    ec.stage(params)
    ec.commit(params)
    end.record()
    end.synchronize()
    update_ms = start.elapsed_time(end)
    assert torch.equal(before, ec.parity), "a zero delta changed the parity"
    del before, opt_state, step_fn
    _free(torch)

    # no stale parity: the parity after the last step is a fresh encode
    # of the live parameters
    fresh = ec.store.encode(params)
    stale = int((fresh != ec.parity).sum())
    del fresh
    assert stale == 0, f"{stale} parity bytes differ from a fresh encode"
    # every data position rebuilds byte for byte; then the control
    live = ec.store.local_pages(params)
    A = TRAIN_MESH[0]
    rec_ms = []
    for f in range(A):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = ec.reconstruct(params, f)
        torch.cuda.synchronize()
        rec_ms.append((time.perf_counter() - t0) * 1e3)
        assert torch.equal(rec[0], live[f]), f"position {f} rebuilds wrong"
        del rec
    # parity row 0 at position 0, stripe 0, protects class j of position
    # (j - k) mod A; flip one byte of it and rebuild class 0's owner
    victim = (0 - ec_cfg.k) % A
    ec.parity[0, 0, 0, 0, 0] ^= 1
    rec = ec.reconstruct(params, victim)
    control_caught = not torch.equal(rec[0], live[victim])
    ec.parity[0, 0, 0, 0, 0] ^= 1
    del rec
    assert control_caught, "a flipped parity byte left the rebuild intact"
    assert all(np.isfinite(losses)), losses
    torch.cuda.synchronize()
    launches = launch_counts()
    assert launches["gf_matmul_batched"] == \
        1 + steps + 1 + 1 + (A + 1) * ec_cfg.k, launches
    nums = dict(
        tokens_per_step=tokens, losses=losses, grad_norms=norms,
        step_s=step_s, tok_per_s=[tokens / s for s in step_s],
        peak_gb=peak_gb, ec_pages=int(ec.parity.shape[-2] * ec_cfg.k),
        ec_parity_gb=ec.parity.numel() / 1e9, ec_encode_ms=encode_ms,
        ec_update_ms=update_ms, ec_reconstruct_ms=rec_ms,
        control_caught=control_caught)
    del ec
    _free(torch)
    return launches, nums, live, ec_cfg


def run_train(np, torch, dev, card, rows):
    """starcoder2-3b training at full width with an EC copy of the
    parameters: step 1's checks (``step1_checks``: kernel 11 against the
    plain attention, bounds from an fp32 twin, a faulted control);
    four steps with the EC copy (``train_with_ec``), kernel 11 launching twice
    per layer a step (forward and remat recompute), step 1's loss and
    norm held to the bounds; then ``launch.train --reduced --ec`` on the
    card, whose loss must fall.  Afterwards, outside the counted run,
    kernel 1 is held against its plain version at the EC update's shape
    and timed there.  Returns the phase's launches and numbers."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    t_phase = time.perf_counter()
    cfg = get_config(MODEL_ARCH)
    assert cfg.remat == "full", cfg.remat
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0),
                       device=dev)
    checks = step1_checks(torch, model, data.batch(0), card, "train")
    big, nums, live, ec_cfg = train_with_ec(np, torch, dev, card, "train",
                                            model, data, TRAIN_STEPS)
    assert big["flash_attention"] == 2 * cfg.num_layers * TRAIN_STEPS, big
    nums.update(checks)
    nums.update(check_step1(card, "train", nums["losses"][0],
                            nums["grad_norms"][0], checks))
    del model
    _free(torch)

    # launch.train on the card (its own launches join the phase's)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        small = launch_train.main(TRAIN_LAUNCH_ARGS)
    launch_s = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"launch.train: {line}")
    assert small[-1] < small[0], f"launch.train's loss did not fall: {small}"
    torch.cuda.synchronize()
    launches = launch_counts()
    _free(torch)

    # kernel 1 at the EC update's shape against its plain version (not
    # counted: a comparison); byte outputs compare by equality (their
    # int32 difference would take 18 GB here)
    items = live.view(-1, ec_cfg.k, ec_cfg.page_size)
    gamma = ec_cfg.gamma
    got = gm.gf256_matmul_batched(gamma, items)
    want = gm.gf256_matmul_batched_plain(gamma, items)
    torch.cuda.synchronize()
    err = 0 if torch.equal(got, want) else int(
        (got != want).sum())
    del got, want
    assert err == 0, f"kernel 1 at the EC shape: {err} bytes differ"
    call = lambda: gm.gf256_matmul_batched(gamma, items)     # noqa: E731
    ms = cuda_ms(torch, call, 3)
    kernel_ms, htod = kernel_device_ms(torch, call, 3,
                                       CUDA_NAMES["gf_matmul_batched"])
    plain_ms = cuda_ms(torch, lambda: gm.gf256_matmul_batched_plain(
        gamma, items), 1)
    nbytes, ops = matmul_work(np, gamma, items)
    b_ms, by = bound(nbytes, ops)
    point = dict(shape=f"({gamma.shape[0]},{gamma.shape[1]})x"
                 f"{tuple(items.shape)}", ms=ms, kernel_ms=kernel_ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                 bytes=nbytes, ops=ops, max_abs_err=err)
    log(f"kernel gf_matmul_batched at the EC update's shape [{card}]: "
        f"{json.dumps(point)}")
    row = next(r for r in rows if r["name"] == "gf_matmul_batched")
    row.setdefault("cases", {})["train_ec_update"] = point
    del live, items
    nums.update(launch_train_losses=small, launch_train_s=launch_s,
                launches=launches, phase_s=time.perf_counter() - t_phase)
    _free(torch)
    log(f"phase train: {nums['phase_s']:.1f} s")
    return launches, nums


def per_call_checks(torch, model, batch, card, label) -> dict:
    """Step 1's forward (``Model.apply`` of ``batch`` on the same weights)
    with every kernel-11 call held against its plain version on the
    inputs the model gives it (``checked_attention``), then with the
    faulted control (the last Q tile's rows skip their own key), which
    must miss that check in every call.  A fault in the forward hardly
    moves this model's loss or gradients (8 of 26 layers attend, the
    softcap bounds the logits), so each call is held instead.  Returns
    the ratios to the tolerance."""
    import repro_torch.models.layers as layers
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    real = layers.flash_attention
    ratios, control = [], []
    try:
        layers.flash_attention = checked_attention(torch, fa, real, ratios)
        model.apply(batch)
        layers.flash_attention = checked_attention(
            torch, fa, faulted_attention(torch, fa), control)
        model.apply(batch)
    finally:
        layers.flash_attention = real
    _free(torch)
    log(f"{label} [{card}] step 1's forward, kernel 11 per call vs its plain "
        f"version (ratio to the tolerance, <= 1): {ratios}; faulted control "
        f"(must exceed 1): {control}")
    assert ratios and max(ratios) <= 1.0, ratios
    assert len(control) == len(ratios) and min(control) > 1.0, control
    return dict(kernel11_call_ratios=ratios, control_call_ratios=control)


def run_train_hybrid(np, torch, dev, card):
    """recurrentgemma-2b training at full width and full depth, checked as
    ``run_train`` checks starcoder2-3b: step 1's checks over its 8 W
    layers (the R layers have no attention) and each kernel-11 call of
    step 1's forward against the plain version (``per_call_checks``),
    then ``HYBRID_TRAIN_STEPS`` steps with the EC copy.  S = 2,048 fits
    the window, so each W layer runs kernel 11 at hd 256 in the forward
    and again in the remat recompute.  Returns the launches and the
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    assert cfg.remat == "full" and TRAIN_SEQ <= cfg.local_window, cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    n_params = sum(p.numel() for p in model.parameters())
    # the first repeats * len(unit) layers are checkpointed and the tail
    # ("RR") is not; it holds no W layer
    n_w = cfg.layers.count("W")
    assert "W" not in model.tail, model.tail
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0),
                       device=dev)
    batch = data.batch(0)
    checks = step1_checks(torch, model, batch, card, "train-hybrid")
    checks.update(per_call_checks(torch, model, batch, card, "train-hybrid"))
    assert len(checks["kernel11_call_ratios"]) == n_w, checks
    launches, nums, live, _ = train_with_ec(
        np, torch, dev, card, "train-hybrid", model, data,
        HYBRID_TRAIN_STEPS)
    del live, model
    assert launches["flash_attention"] == 2 * n_w * HYBRID_TRAIN_STEPS, \
        launches
    nums.update(checks)
    nums.update(check_step1(card, "train-hybrid", nums["losses"][0],
                            nums["grad_norms"][0], checks))
    nums.update(parameters=n_params, w_layers=n_w,
                flash_launches=launches["flash_attention"],
                phase_s=time.perf_counter() - t_phase)
    _free(torch)
    log(f"phase train-hybrid: {nums['phase_s']:.1f} s")
    return launches, nums


# the other families at full width, depth cut as run_families cuts them
# (mamba2-370m at its full 48 layers): (arch, layers, B, S)
TRAIN_FAMILIES = [("qwen2-vl-7b", 2, 2, 256), ("musicgen-medium", 2, 2, 256),
                  ("minicpm3-4b", 2, 2, 256), ("mamba2-370m", 48, 2, 2048)]
# bf16 step 1 against the fp32 twin's on the same weights, relative: the
# loss, the norm and, tensor by tensor, every gradient (Frobenius).
# Readings on an H100 80GB HBM3 (700 W), seed 0: loss 2.4e-5 to 1.15e-4,
# norm 2.1e-7 to 6.5e-4 over the four configs; gradients 0.0136
# (minicpm3-4b, MLA), 0.0146 (musicgen-medium), 0.0290 (qwen2-vl-7b: wq
# and wk, as starcoder2-3b's and recurrentgemma-2b's twins read 0.03 to
# 0.09 there) and 0.066 to 0.071 in mamba2-370m's matrices and scales,
# whose bf16 roundings add up over 48 layers.  The bounds are about ten
# times the loss's, five times the norm's and twice the gradients'
# largest reading.  Mamba-2's per-head vectors read more (A_log 0.197,
# dt_bias 0.118, D 0.081; A_log 0.032 on the CPU's reduced config): each
# of their elements is a sum over every position and channel of a head
# whose terms cancel (the CPU twins' A_log bounds say the same), so
# bf16's roundings show larger there; their bound is 0.5.  The control,
# Mamba-2's gradient dropped over its last SSD chunk
# (``last_chunk_detached``), must exceed some tensor's bound: its
# matrices and scales read 0.35 to 0.38, A_log 0.73, D and dt_bias 0.47.
FAMILY_LOSS_TOL = 1e-3
FAMILY_NORM_TOL = 3e-3
FAMILY_LEAF_TOL = 0.15
FAMILY_PER_HEAD_TOL = 0.5
FAMILY_PER_HEAD = ("mamba.A_log", "mamba.dt_bias", "mamba.D")


def family_leaf_bound(name: str) -> float:
    return FAMILY_PER_HEAD_TOL if name.endswith(FAMILY_PER_HEAD) \
        else FAMILY_LEAF_TOL


def last_chunk_detached(torch, real):
    """The families' control: a Mamba-2 mixer whose output over the last
    SSD chunk is detached - the same forward, but no gradient flows back
    through those positions."""
    def forward(p, x, cfg):
        y = real(p, x, cfg)
        Q = min(cfg.ssm_chunk, x.shape[1])
        return torch.cat([y[:, :-Q], y[:, -Q:].detach()], dim=1)
    return forward


def worst_by_kind(errors: dict) -> dict:
    """Per parameter kind (the name without its layer index), the largest
    error over the layers, ordered by its ratio to the bound."""
    out = {}
    for n, e in errors.items():
        kind = re.sub(r"^layers\.\d+\.", "layers.*.", n)
        out[kind] = max(out.get(kind, 0.0), e)
    return dict(sorted(out.items(),
                       key=lambda kv: -kv[1] / family_leaf_bound(kv[0])))


def leaf_errors(got, want) -> dict:
    """Per parameter, |g - g_want| / |g_want| (Frobenius, fp32); where
    ``want`` is all zero (a table the loss does not read), |g|."""
    out = {}
    for n, w in want.items():
        d = float((got[n].float() - w.float()).norm())
        wn = float(w.float().norm())
        out[n] = d / wn if wn else d
    return out


def run_train_families(np, torch, dev, card):
    """Each config of ``TRAIN_FAMILIES`` at full width: step 1's loss,
    norm and every parameter's gradient in bf16 (kernel 11 in every
    attention layer, twice: forward and recompute) against an fp32 twin
    of the same weights (its own path, kernel 11's fp32 body), with the
    Mamba-2 control (``last_chunk_detached``), then one timed AdamW step of
    ``make_train_step``.  Batches from ``SyntheticLM`` as
    ``launch.train`` makes them (embeddings and M-RoPE positions where the
    config takes them).  Returns the launches of the timed steps and each
    config's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model, transformer
    from repro_torch.models.convert import param_tree
    from repro_torch.models.transformer import MIXER_KINDS
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    t_phase = time.perf_counter()
    total, nums = {}, {}
    for arch, n_layers, Bf, Sf in TRAIN_FAMILIES:
        _free(torch)
        t0 = time.perf_counter()
        cfg = get_config(arch).scaled(num_layers=n_layers)
        assert cfg.remat == "full", cfg.remat
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = Model(cfg, device=dev).init(gen)
        n_params = sum(p.numel() for p in model.parameters())
        data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=Sf, global_batch=Bf,
            embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0,
            mrope=cfg.rope_kind == "mrope"), device=dev)
        batch = data.batch(0)
        loss, norm, grads = step1_grads(torch, model, batch, fa,
                                        "flash_attention_backward", None,
                                        every=True)
        twin = fp32_twin(torch, model)
        twin_loss, twin_norm, twin_grads = step1_grads(
            torch, twin, batch, fa, "flash_attention_backward", None,
            every=True)
        del twin
        leaf = leaf_errors(grads, twin_grads)
        del grads
        control = None
        if "S" in cfg.layers:
            _, _, bad = step1_grads(
                torch, model, batch, transformer, "mamba2_forward",
                last_chunk_detached(torch, transformer.mamba2_forward),
                every=True)
            control = leaf_errors(bad, twin_grads)
            del bad
        del twin_grads
        _free(torch)
        opt = make_optimizer("adamw", lr=1e-3, warmup_steps=1,
                             total_steps=1)
        params = param_tree(model)
        opt_state = opt.init(params)
        step_fn = make_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t1 = time.perf_counter()
        _, _, metrics = step_fn(params, opt_state, batch)
        step_loss = float(metrics["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        launches = launch_counts()
        n_rep = model.repeats * len(model.unit)
        want = sum(2 if i < n_rep else 1 for i, k in enumerate(cfg.layers)
                   if MIXER_KINDS[k] == "attn")
        assert launches["flash_attention"] == want, (arch, launches, want)
        assert sum(launches.values()) == want, (arch, launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        loss_err = abs(loss - twin_loss) / twin_loss
        norm_err = abs(norm - twin_norm) / twin_norm
        nums[arch] = dict(
            layers=n_layers, batch=f"{Bf}x{Sf}", parameters=n_params,
            step1_loss=loss, fp32_twin_step1_loss=twin_loss,
            step1_loss_rel_err=loss_err, step1_grad_norm=norm,
            fp32_twin_step1_grad_norm=twin_norm,
            step1_grad_norm_rel_err=norm_err, grad_rel_err=worst_by_kind(leaf),
            control_grad_rel_err=control and worst_by_kind(control),
            step_loss=step_loss,
            step_s=step_s, tok_per_s=Bf * Sf / step_s,
            flash_launches=launches["flash_attention"],
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            seconds=time.perf_counter() - t0)
        log(f"train family {arch} [{card}]: {json.dumps(nums[arch])}")
        assert np.isfinite(step_loss), (arch, step_loss)
        assert loss_err <= FAMILY_LOSS_TOL, (arch, loss_err)
        assert norm_err <= FAMILY_NORM_TOL, (arch, norm_err)
        assert all(e <= family_leaf_bound(n) for n, e in leaf.items()), \
            (arch, nums[arch]["grad_rel_err"])
        assert control is None or any(
            e > family_leaf_bound(n) for n, e in control.items()), \
            (arch, nums[arch]["control_grad_rel_err"])
        del model, params, opt_state, step_fn, batch
    _free(torch)
    log(f"phase train-families: {time.perf_counter() - t_phase:.1f} s")
    return total, nums


# the MoE archs train on the card at their reduced config only: one
# full-width layer holds 40.66 GB (llama4-maverick) or 43.50 GB (kimi-k2)
# of bf16 weights, and its gradients and AdamW state several times that
MOE_TRAIN = ("llama4-maverick-400b-a17b", "kimi-k2-1t-a32b")
MOE_TRAIN_SEQ = 64
# the card's fp32 step against the CPU's on the same weights and batch,
# tests/test_torch_gpu.py's bounds: the loss absolute, the norm and each
# gradient leaf relative (Frobenius; llama4's top-1 router, zero in exact
# arithmetic, held absolutely), the parameters after the step absolute
MOE_TRAIN_TOL = 1e-5
MOE_ZERO_TOL = 1e-8
MOE_PARAM_TOL = 5e-5


def run_train_moe(np, torch, dev, card):
    """Each MoE arch at its reduced config in fp32: one AdamW step of
    ``make_train_step`` on the card (kernel 11 in its attention layers)
    against the same step on the CPU from the same weights
    (``recorded_step`` both): the loss, the norm, every gradient leaf,
    the parameters after the step, each MoE layer's top-K experts and
    the dropped assignments (``moe.DROPS``, counted once a forward).
    Returns the card steps' launches and the numbers."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import recorded_step
    t_phase = time.perf_counter()
    total, nums = {}, {}

    def adamw():
        return make_optimizer("adamw", lr=1e-3, warmup_steps=2,
                              total_steps=10)

    for arch in MOE_TRAIN:
        cfg = get_reduced(arch).scaled(dtype="float32")
        cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        model = Model(cfg, device=dev)
        model.load_state_dict(cpu.state_dict())
        batch = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=MOE_TRAIN_SEQ,
            global_batch=TRAIN_BATCH), device="cpu").batch(0)
        want = recorded_step(cpu, adamw(), batch)
        reset_launch_counts()
        got = recorded_step(model, adamw(),
                            {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        launches = launch_counts()
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        n_moe = cfg.layers.count("M")
        routes_equal = len(got["routes"]) == len(want["routes"]) == n_moe \
            and all(torch.equal(g, w)
                    for g, w in zip(got["routes"], want["routes"]))
        norm = want["grad_norm"]
        zero = {n for n in want["grads"] if cfg.experts_per_token == 1
                and n.endswith("moe/router")}
        leaf = {n: float((got["grads"][n] - w).norm() / w.norm())
                for n, w in want["grads"].items() if n not in zero}
        worst = max(leaf, key=leaf.get)
        nums[arch] = dict(
            loss=got["loss"], cpu_loss=want["loss"],
            loss_err=abs(got["loss"] - want["loss"]),
            grad_norm=got["grad_norm"], cpu_grad_norm=norm,
            grad_norm_rel_err=abs(got["grad_norm"] - norm) / norm,
            worst_leaf=worst, worst_leaf_rel_err=leaf[worst],
            zero_leaves={n: [float(got["grads"][n].norm()),
                             float(want["grads"][n].norm())] for n in zero},
            param_err=max(float((got["params"][n] - w).abs().max())
                          for n, w in want["params"].items()),
            dropped=got["drops"], cpu_dropped=want["drops"],
            routes_equal=routes_equal,
            flash_launches=launches["flash_attention"])
        log(f"train moe {arch} (reduced, fp32) [{card}] vs the CPU: "
            f"{json.dumps(nums[arch])}")
        r = nums[arch]
        assert r["loss_err"] <= MOE_TRAIN_TOL, r
        assert r["grad_norm_rel_err"] <= MOE_TRAIN_TOL, r
        assert r["worst_leaf_rel_err"] <= MOE_TRAIN_TOL, r
        assert all(max(v) <= MOE_ZERO_TOL * norm
                   for v in r["zero_leaves"].values()), r
        assert r["param_err"] <= MOE_PARAM_TOL, r
        assert routes_equal and got["drops"] == want["drops"], r
        assert launches["flash_attention"] == 2 * n_moe, launches
        del cpu, model, got, want
    _free(torch)
    log(f"phase train-moe: {time.perf_counter() - t_phase:.1f} s")
    return total, nums


def run_tune(np, torch, dev, card):
    """The shape tuner on the card (``kernels.tune.autotune_ci_shapes``)
    into a temporary cache named by ``$MEMEC_TORCH_TUNE_CACHE``: first
    every candidate of every shape against the plain version, byte for
    byte (not counted); then the sweep, each shape's winner and its µs
    beside the µs of the body the built-in rule picks; then, with that
    cache, one call per shape must launch the winner's kernel (for a
    per-item shape, in the winner's coefficient form), and with the
    committed defaults (no ``cuda-kernel`` entry) today's body.  Returns
    the phase's launches (sweep and steered calls) and its numbers."""
    import os
    import tempfile
    import warnings

    from repro_torch.kernels import (coefs, dispatch, launch_counts,
                                     reset_launch_counts, tune)
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    du = importlib.import_module("repro_torch.kernels.delta_update")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    matmul, per_item = tune.ci_shapes()
    cases = []
    for A, chunk, batch in matmul:
        A = np.ascontiguousarray(A, dtype=np.uint8)
        data = u8(batch, A.shape[1], chunk)
        cases.append(("matmul", A, batch, (data,)))
    for M, chunk, batch in per_item:
        Ms = np.ascontiguousarray(np.broadcast_to(M, (batch,) + M.shape))
        cases.append(("delta_per_item", Ms, batch,
                      (u8(batch, M.shape[1], chunk),
                       u8(batch, M.shape[0], chunk))))

    def call(op, A, batch, tensors, strategy=None):
        if op == "delta_per_item":
            blocks, parity = tensors
            return du.delta_apply_per_item_batched(parity, A, blocks,
                                                   strategy=strategy)
        if batch == 1:
            return gm.gf256_matmul(A, tensors[0][0], strategy=strategy)
        return gm.gf256_matmul_batched(A, tensors[0], strategy=strategy)

    def plain(op, A, batch, tensors):
        if op == "delta_per_item":
            return gm.gf256_matmul_per_item_plain(A, tensors[0], tensors[1])
        if batch == 1:
            return gm.gf256_matmul_plain(A, tensors[0][0])
        return gm.gf256_matmul_batched_plain(A, tensors[0])

    # every candidate's bytes against the plain version (not counted)
    checked = 0
    for op, A, batch, tensors in cases:
        m, k = A.shape[-2:]
        want = plain(op, A, batch, tensors)
        for cand in tune.candidates(op, dispatch.CUDA, m=m, k=k,
                                    is01=coefs.is01(A)):
            got = call(op, A, batch, tensors, cand["strategy"])
            assert torch.equal(got, want), (op, A.shape, batch, cand)
            checked += 1
    torch.cuda.synchronize()

    forms = []
    real_host = gm.per_item_host

    def spy(Ms, strategy):
        out = real_host(Ms, strategy)
        forms.append("gf01" if out[0] else "cols")
        return out

    def kernel_of(op, A, batch, strategy):
        """(kernel, per-item form) a call with ``strategy`` launches."""
        if op == "delta_per_item":
            k = A.shape[-1]
            form = ("gf01" if strategy != "cols" and coefs.is01(A)
                    and k <= coefs.MAX_MASK_COLS else "cols")
            return "gf_per_item_fold", form
        s = gm.choose_strategy(A, strategy)
        return ("gf_matmul" if batch == 1 and s == "unroll"
                else gm._KERNEL_OF[s]), None

    def steered(label):
        """One call per shape with the active cache; each must launch the
        kernel (and form) its cache entry names, or the rule's."""
        total = dict.fromkeys(launch_counts(), 0)
        gm.per_item_host = spy
        try:
            for op, A, batch, tensors in cases:
                m, k = A.shape[-2:]
                entry = tune.lookup(op, dispatch.CUDA, k=k, m=m,
                                    chunk=tensors[0].shape[-1], batch=batch,
                                    cls=tune.matrix_cls(A))
                want = kernel_of(op, A, batch,
                                 entry["strategy"] if entry else None)
                forms.clear()
                reset_launch_counts()
                call(op, A, batch, tensors)
                torch.cuda.synchronize()
                n = launch_counts()
                launched = {kk: v for kk, v in n.items() if v}
                assert launched == {want[0]: 1}, (label, op, A.shape,
                                                  entry, launched)
                if want[1]:
                    assert forms == [want[1]], (label, entry, forms)
                for kk, v in n.items():
                    total[kk] += v
        finally:
            gm.per_item_host = real_host
        return total

    saved = os.environ.get(tune.ENV)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[tune.ENV] = os.path.join(tmp, "tune.json")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # "not found": it is new
                tune.load_cache(reload=True)
            reset_launch_counts()
            t0 = time.perf_counter()
            results = tune.autotune_ci_shapes(verbose=False, device=dev)
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - t0
            launches = launch_counts()
            tuned = steered("tuned")
            tune.save()
            saved_cache = json.loads(Path(tune.cache_path()).read_text())
        finally:
            if saved is None:
                os.environ.pop(tune.ENV, None)
            else:
                os.environ[tune.ENV] = saved
            tune.load_cache(reload=True)
    assert not any(k.split("/")[1] == dispatch.CUDA
                   for k in tune.load_cache()), "defaults hold card entries"
    default = steered("defaults")
    winners = []
    for (op, A, batch, tensors), res in zip(cases, results):
        rule = (gm.choose_strategy(A) if op == "matmul"
                else kernel_of(op, A, batch, None)[1])
        winners.append({
            "op": op, "shape": f"k{A.shape[-1]}m{A.shape[-2]}"
                                f"c{tensors[0].shape[-1]}b{batch}",
            "winner": res["strategy"], "winner_us": res["timings"][
                res["strategy"]], "rule": rule,
            "rule_us": res["timings"].get(rule), "timings": res["timings"]})
    for w in winners:
        log(f"tune [{card}]: {json.dumps(w)}")
    for kk in launches:
        launches[kk] += tuned[kk]
    nums = dict(candidates_checked=checked, sweep_s=sweep_s,
                entries=len(saved_cache["entries"]), winners=winners,
                default_launches={k: v for k, v in default.items() if v},
                phase_s=time.perf_counter() - t_phase)
    log(f"phase tune: {nums['phase_s']:.1f} s")
    return launches, nums


# the ranks phase: (a) the training copy's layout (``TRAIN_MESH``,
# ``TRAIN_EC``: the reference example's code, mesh and page) on
# starcoder2-3b's parameters at full width and depth, one rank a
# position; (b) the production code, RS(10,8) with 4 KB pages over
# (12, 1), on ``RANKS_CODE_BYTES`` of seeded pages a rank.  Gloo ranks on
# ``cuda:0`` (NCCL refuses two ranks on one card), joined within a
# deadline that kills them
RANKS_SEED = 23
RANKS_CODE = dict(k=8, m=2, page_size=4096)
RANKS_CODE_MESH = (12, 1)
RANKS_CODE_BYTES = 64 << 20
RANKS_PAIR = (0, 5)
RANKS_DEADLINE = {"state": 300.0, "code": 180.0}


def flip_leaves(torch, tree, specs, flips, mesh=None, coords=None):
    """The seeded in-place change of the ranks phase: every byte of leaf i
    XORed with ``flips[i]`` (an involution).  With ``mesh`` and
    ``coords``: only the blocks that position writes
    (``sharding.writes_block``), so that the ranks sharing a leaf's
    storage change each byte once."""
    from repro_torch.distributed.sharding import writes_block
    from repro_torch.tree import Stacked, leaves
    for leaf, spec, c in zip(leaves(tree), leaves(specs), flips):
        if mesh is not None and not writes_block(spec, mesh, coords):
            continue
        for part in (leaf.parts if isinstance(leaf, Stacked) else [leaf]):
            v = part.detach()
            v = v.unsqueeze(0) if v.dim() == 0 else v
            v.view(torch.uint8).bitwise_xor_(c)


def _rank_timed(torch, ops, name, fn, *args):
    """``fn(*args)`` on a rank between two synchronisations: its wall s
    and the bytes the rank sent (``collectives.recording``)."""
    from repro_torch.distributed.collectives import recording
    sent = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(lambda n, kind: sent.append(n)):
        out = fn(*args)
    torch.cuda.synchronize()
    ops[name] = {"s": time.perf_counter() - t0, "bytes_sent": sum(sent)}
    return out


def _differ(torch, got, want) -> int:
    """Bytes of ``got`` that differ from ``want`` (0 when equal)."""
    if tuple(got.shape) != tuple(want.shape):
        return got.numel() or 1
    return 0 if torch.equal(got, want) else int((got != want).sum())


def rank_state_body(comm, local, specs, ec_kw, flips, want):
    """Ranks phase (a), one rank: ``ECCheckpoint(comm=...)`` on the rank's
    blocks of the parent's parameters (shared, not copied): ``create``,
    ``stage``, the seeded in-place change of the blocks the rank writes
    (between barriers, so no rank packs a shared block while another
    changes it), ``commit``, and the rebuild of data index 0, each held
    byte for byte against the stacked store's result at the rank's
    coordinate (``want``, computed by the parent on the card)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.ecstore import ECConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.checkpoint import ECCheckpoint
    torch.cuda.set_device(0)
    cfg = ECConfig(**ec_kw)
    ec = ECCheckpoint(comm.mesh, specs, cfg, comm)
    ops, diff = {}, {}
    reset_launch_counts()
    _rank_timed(torch, ops, "create", ec.create, local)
    diff["create"] = _differ(torch, ec.parity, want["create"])
    _rank_timed(torch, ops, "stage", ec.stage, local)
    dist.barrier()
    _rank_timed(torch, ops, "change", flip_leaves, torch, local, specs,
                flips, comm.mesh, comm.coords)
    dist.barrier()
    _rank_timed(torch, ops, "commit", ec.commit, local)
    diff["commit"] = _differ(torch, ec.parity, want["commit"])
    rec = _rank_timed(torch, ops, "reconstruct0", ec.reconstruct, local, 0)
    diff["reconstruct0"] = _differ(torch, rec, want["rebuild0"])
    return dict(coords=comm.coords, pages=int(ec.parity.shape[1]) * cfg.k,
                ops=ops, diff=diff, launches=launch_counts(),
                op_paths=dict(comm.op_paths),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def rank_code_body(comm, pages, xor, ec_kw, pair, want):
    """Ranks phase (b), one rank: ``rank_encode_parity``, then
    ``rank_parity_delta_update`` and ``rank_parity_delta_update_chain`` of
    a seeded delta, then the pair rebuild of ``pair`` both ways, each held
    byte for byte against the stacked store's (``want``)."""
    import torch
    from repro_torch.distributed import ecstore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.set_device(0)
    cfg = ecstore.ECConfig(**ec_kw)
    ops, diff = {}, {}
    reset_launch_counts()
    enc = _rank_timed(torch, ops, "encode", ecstore.rank_encode_parity,
                      pages, cfg, comm)
    diff["encode"] = _differ(torch, enc, want["encode"])
    for name, fn in (("update", ecstore.rank_parity_delta_update),
                     ("update_chain",
                      ecstore.rank_parity_delta_update_chain)):
        got = _rank_timed(torch, ops, name, fn, xor, enc, cfg, comm)
        diff[name] = _differ(torch, got, want[name])
    f1, f2 = pair
    for a, b in ((f1, f2), (f2, f1)):
        got = _rank_timed(torch, ops, f"pair{a}_{b}",
                          ecstore.rank_reconstruct_failed_pair, pages, enc,
                          a, b, cfg, comm)
        diff[f"pair{a}_{b}"] = _differ(torch, got, want[f"pair{a}_{b}"])
    return dict(coords=comm.coords, pages=int(pages.shape[0]), ops=ops,
                diff=diff, launches=launch_counts(),
                op_paths=dict(comm.op_paths))


def _check_ranks(results, label, sends, card) -> dict:
    """Every rank's results equal the stacked store's, its bytes sent
    equal ``sends[op]`` (bytes of one call), kernel 1 launched and every
    product took the kernel; returns the launches summed over ranks."""
    total = {}
    for res in results:
        log(f"ranks {label} [{card}] rank at {tuple(res['coords'])}: "
            f"{json.dumps({k: res[k] for k in res if k != 'coords'})}")
        assert not any(res["diff"].values()), (label, res["coords"],
                                               res["diff"])
        for op, want in sends.items():
            got = res["ops"][op]["bytes_sent"]
            assert got == want, (label, res["coords"], op, got, want)
        assert res["launches"]["gf_matmul_batched"] > 0, res["launches"]
        assert set(res["op_paths"].values()) == {"cuda-kernel"}, \
            res["op_paths"]
        for name, n in res["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def run_ranks(np, torch, dev, card):
    """The EC store with one mesh position per rank
    (``distributed/ranks.py``), spawned ranks under gloo on this card
    (module notes at ``RANKS_SEED``): (a) starcoder2-3b's parameters over
    ``TRAIN_MESH`` with ``TRAIN_EC`` through ``ECCheckpoint(comm=...)``,
    (b) ``RANKS_CODE`` over ``RANKS_CODE_MESH``.  The parent computes the
    stacked store's results on the card first; every rank must equal
    them at its coordinate byte for byte, send m*k*S pages an update and
    (A - 1)*k*S a rebuild, launch kernel 1 and take no CPU or plain path.
    A failed or hung rank fails the phase.  Returns the ranks' launches
    and the numbers."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ecstore
    from repro_torch.distributed import ranks as rk
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.convert import param_tree
    from repro_torch.tree import Stacked, leaves, tree_map
    t_phase = time.perf_counter()
    nums = {"allocated_gb_before": torch.cuda.memory_allocated() / 1e9}

    # (a) the paper's state at full size
    t0 = time.perf_counter()
    cfg = get_config(MODEL_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    params = tree_map(lambda x: Stacked(p.detach() for p in x.parts)
                      if isinstance(x, Stacked) else x.detach(),
                      param_tree(model))
    mesh = make_mesh(TRAIN_MESH, ("data", "model"))
    specs = shd.param_specs(cfg, params, mesh)
    ec_cfg = ecstore.ECConfig(**TRAIN_EC)
    store = ecstore.ECStateStore(mesh, specs, ec_cfg)
    flips = [int(c) for c in np.random.default_rng(RANKS_SEED).integers(
        1, 256, len(leaves(params)))]
    with torch.no_grad():
        enc_old = store.encode(params)
        flip_leaves(torch, params, specs, flips)
        enc_new = store.encode(params)
        rebuilt = store.reconstruct(params, enc_new, 0)
        live = store.pack(params)
        assert torch.equal(rebuilt[0], live[0]), "stacked rebuild of 0"
        del live
        rebuild0 = rebuilt[0, 0]
        assert not torch.equal(enc_old, enc_new), "the change changed nothing"
        flip_leaves(torch, params, specs, flips)
    torch.cuda.synchronize()
    _free(torch)
    P = int(enc_old.shape[-2]) * ec_cfg.k
    S, page, A = P // ec_cfg.k, ec_cfg.page_size, TRAIN_MESH[0]
    nums["state"] = dict(pages_per_rank=P, gb_per_rank=P * page / 1e9,
                         stacked_s=time.perf_counter() - t0)
    log(f"ranks (a): starcoder2-3b, {mesh.axis_sizes} mesh, "
        f"RS({ec_cfg.n},{ec_cfg.k}) {page}-byte pages: {P} pages "
        f"({P * page / 1e9:.3f} GB) a rank; no cut")
    def rank_of(at):
        local = tree_map(lambda leaf, spec: shd.local_block(leaf, spec,
                                                            mesh, at),
                         params, specs)
        return (local, specs, TRAIN_EC, flips,
                {"create": enc_old[at], "commit": enc_new[at],
                 "rebuild0": rebuild0})
    rank_args = [rank_of(mesh.coords(r)) for r in range(mesh.size)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        res = rk.launch(rank_state_body, mesh, rank_args,
                        init_file=os.path.join(tmp, "init"),
                        timeout=RANKS_DEADLINE["state"])
    nums["state"]["spawn_s"] = time.perf_counter() - t0
    update = ec_cfg.m * ec_cfg.k * S * page
    launches = _check_ranks(res, "(a)", {
        "create": update, "commit": update,
        "reconstruct0": (A - 1) * ec_cfg.k * S * page}, card)
    with torch.no_grad():
        after = store.encode(params)
        assert torch.equal(after, enc_new), \
            "the ranks' in-place change is not the parent's"
    nums["state"]["ranks"] = [dict(coords=x["coords"], ops=x["ops"],
                                   launches=x["launches"]["gf_matmul_batched"],
                                   peak_gb=x["peak_gb"]) for x in res]
    del rank_args, enc_old, enc_new, rebuilt, rebuild0, after, store
    del params, model
    _free(torch)
    torch.cuda.ipc_collect()

    # (b) the production code on seeded pages
    mesh = make_mesh(RANKS_CODE_MESH, ("data", "model"))
    cfg_b = ecstore.ECConfig(**RANKS_CODE)
    A, page = RANKS_CODE_MESH[0], cfg_b.page_size
    P = RANKS_CODE_BYTES // page
    S = P // cfg_b.k
    gen = torch.Generator(device=dev)
    gen.manual_seed(RANKS_SEED)
    pages, xor = (torch.randint(0, 256, RANKS_CODE_MESH + (P, page),
                                dtype=torch.uint8, device=dev, generator=gen)
                  for _ in range(2))
    enc = ecstore.encode_parity(pages, cfg_b)
    want = {"encode": enc,
            "update": ecstore.parity_delta_update(xor, enc, cfg_b),
            "update_chain": ecstore.parity_delta_update_chain(xor, enc,
                                                              cfg_b)}
    f1, f2 = RANKS_PAIR
    for a, b in ((f1, f2), (f2, f1)):
        rec = ecstore.reconstruct_failed_pair(pages, enc, a, b, A, cfg_b)
        assert torch.equal(rec[0, 0], pages[a, 0]), "stacked pair rebuild"
        want[f"pair{a}_{b}"] = rec
    torch.cuda.synchronize()
    rank_args = []
    for r in range(mesh.size):
        at = mesh.coords(r)
        rank_args.append((pages[at], xor[at], RANKS_CODE, RANKS_PAIR,
                          {k: v[at] for k, v in want.items()}))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        res = rk.launch(rank_code_body, mesh, rank_args,
                        init_file=os.path.join(tmp, "init"),
                        timeout=RANKS_DEADLINE["code"])
    update = cfg_b.m * cfg_b.k * S * page
    rebuild = (A - 1) * cfg_b.k * S * page
    more = _check_ranks(res, "(b)", {
        "encode": update, "update": update,
        "update_chain": (cfg_b.k * cfg_b.m + cfg_b.m * (cfg_b.m - 1) // 2)
        * S * page,
        f"pair{f1}_{f2}": rebuild, f"pair{f2}_{f1}": rebuild}, card)
    for name, n in more.items():
        launches[name] = launches.get(name, 0) + n
    nums["code"] = dict(pages_per_rank=P, spawn_s=time.perf_counter() - t0,
                        ranks=[dict(coords=x["coords"], ops=x["ops"])
                               for x in res])
    del rank_args, pages, xor, enc, want, rec
    _free(torch)
    torch.cuda.ipc_collect()
    nums["allocated_gb_after"] = torch.cuda.memory_allocated() / 1e9
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"phase ranks: {nums['phase_s']:.1f} s")
    return launches, nums


# the model-ranks phase: starcoder2-3b at full width over (data 2, model
# 2), one rank a position, gloo on this card; its decode steps cut from 8
# to 4 to make room for the serve-ranks phase (a step sends ~2.3-2.9 GB a
# rank: ~3.2-4.3 s over gloo on an H100 80GB HBM3 at 700 W, PERF.md §5),
# its depth from 30 to 8 layers for the recurrent-ranks phase (59.8 s at
# 30 layers, chip_smoke 1,001.9 s with it on that card; 45.1 s at 15,
# chip_smoke 1,192.3 s on a slower host), and to 4 with its "head" pass
# (a prefill and a decode step) dropped for the moe-ranks phase, whose
# full-width kimi-k2 layer runs the "head" path on the card (chip_smoke
# 1,180.8-1,233.4 s on slow hosts before)
MODEL_RANKS_LAYERS = 4
MODEL_RANKS_MESH = (2, 2)
MODEL_RANKS_PREFILL = (2, 2048)
MODEL_RANKS_DECODE = {"seq": 4}
MODEL_RANKS_RAGGED = 1500
MODEL_RANKS_TWIN_MULTIPLE = 2
MODEL_RANKS_DEADLINE = 600.0


def stripe_checks(torch, dev, cfg, card) -> dict:
    """Kernel 11 on the stripes a (2, 2) rank of ``cfg`` launches: at the
    rank shape (S 2,048) and at ``MODEL_RANKS_RAGGED``, each stripe index
    against the plain version with the same stripe, within the
    per-element bound; the same rows launched with the other stripe index
    must miss it (the faulted control).  The rank shape's second stripe
    (its heavier) is timed (a wrapper call, and the kernel's device time
    from a profiler trace) beside the plain version and
    ``scaled_dot_product_attention`` with the stripe's boolean mask (a
    yardstick the port never calls); its bound takes the causal pairs the
    stripe keeps."""
    from repro_torch.kernels import launch_counts
    from repro_torch.models.ranked import seq_stripe
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    M = MODEL_RANKS_MESH[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {}
    for S in (MODEL_RANKS_PREFILL[1], MODEL_RANKS_RAGGED):
        k, v = (torch.randn((1, S, KV, hd), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        for m in range(M):
            st = seq_stripe(cfg, S, M, m)
            stripe = (st["bq"], M, m)
            q = torch.randn((1, st["rows"], H, hd), generator=gen,
                            device=dev).to(torch.bfloat16)
            before = launch_counts()["flash_attention"]
            got = fa.flash_attention(q, k, v, stripe=stripe)
            torch.cuda.synchronize()
            assert launch_counts()["flash_attention"] == before + 1
            want = fa.flash_attention_plain(q, k, v, stripe=stripe)
            ratio = fa.tolerance_ratio(got, want)
            wrong = fa.tolerance_ratio(fa.flash_attention(
                q, k, v, stripe=(st["bq"], M, 1 - m)), want)
            out[f"S{S}_m{m}"] = dict(stripe=list(stripe), rows=st["rows"],
                                     valid=st["valid"], ratio=ratio,
                                     wrong_stripe_ratio=wrong)
            assert ratio <= 1.0, (S, m, ratio)
            assert wrong > 1.0, f"a wrong stripe holds at S {S}: {wrong}"
            if S != MODEL_RANKS_PREFILL[1] or m != M - 1:
                continue
            mask = (fa.stripe_positions(st["rows"], stripe, dev)[:, None]
                    >= torch.arange(S, device=dev)[None, :])
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            ops = fa.flash_flops(q.shape, k.shape, True, stripe)
            b_ms, b_by = bound(nbytes, ops, BF16_FLOPS_PER_S)
            out["timed"] = dict(
                shape=[1, st["rows"], S, H, KV, hd], stripe=list(stripe),
                ms=cuda_ms(torch, lambda: fa.flash_attention(
                    q, k, v, stripe=stripe), 50),
                kernel_ms=kernel_device_ms(torch, lambda: fa.flash_attention(
                    q, k, v, stripe=stripe), 20, WGMMA_BODY)[0],
                graph_ms=graph_device_ms(torch, lambda: fa.flash_attention(
                    q, k, v, stripe=stripe), 20),
                plain_ms=cuda_ms(torch, lambda: fa.flash_attention_plain(
                    q, k, v, stripe=stripe), 5),
                library_ms=cuda_ms(
                    torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True), 20),
                bound_ms=b_ms, bound_by=b_by, ops=ops, card=card)
    return out


def rank_model_body(comm, cfg, local, tokens, want):
    """Model-ranks phase, one rank: ``RankModel`` on the rank's blocks
    (shared with the parent, not copied), for each attention mode a
    prefill and teacher-forced decode steps, each held against the
    one-card model's logits block of this rank (``want``: views of the
    parent's logits), after a warm-up prefill of 64 tokens; their
    seconds, bytes sent by kind, launches, ``op_paths`` and the peak."""
    import torch
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.ranks import rank_comms
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layers
    from repro_torch.models.ranked import RankModel
    torch.cuda.set_device(0)
    layers.set_activation_mesh(rank_comms(comm))
    out = {"coords": comm.coords}
    # a short warm-up prefill: the first gathers, the staging buffers'
    # growth and the first launches stay out of the timed calls
    RankModel(cfg, local).apply({"tokens": tokens[:, :64]})
    launches = None
    for mode, steps in MODEL_RANKS_DECODE.items():
        model = RankModel(cfg.scaled(attn_parallel=mode), local)
        sent = {"prefill": {}, "decode": {}}

        def note(part):
            def add(n, kind):
                sent[part][kind] = sent[part].get(kind, 0) + n
            return add
        layers.reset_op_paths()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording(note("prefill")):
            logits = model.apply({"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        n = launch_counts()
        launches = n if launches is None else {
            k: launches[k] + n[k] for k in n}
        err = float((logits.float() - want["prefill"].float()).abs().max())
        del logits
        cache = model.init_cache(tokens.shape[0], MODEL_RANKS_DECODE["seq"],
                                 dtype=torch.bfloat16)
        dec_err, t0 = 0.0, time.perf_counter()
        with recording(note("decode")):
            for t in range(steps):
                lg, cache = model.decode_step(cache, tokens[:, t], t)
                dec_err = max(dec_err, float(
                    (lg.float() - want["decode"][:, t].float()).abs().max()))
        torch.cuda.synchronize()
        out[mode] = dict(prefill_s=prefill_s,
                         decode_s_per_step=(time.perf_counter() - t0) / steps,
                         prefill_err=err, decode_err=dec_err,
                         flash_launches=n["flash_attention"],
                         other_launches={k: v for k, v in n.items()
                                         if v and k != "flash_attention"},
                         sent=sent, op_paths=dict(model.op_paths),
                         routes=dict(layers.OP_PATHS))
        del cache, model
    layers.set_activation_mesh(None)
    out["launches"] = launches
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def run_model_ranks(np, torch, dev, card):
    """starcoder2-3b over (data 2, model 2), one rank a position
    (``models/ranked.py``), against the one-card model on the same
    weights: kernel 11's stripes first (``stripe_checks``), then the
    one-card bf16 model's prefill and ``MODEL_RANKS_DECODE["seq"]``
    decode steps and an fp32 twin's, whose distance from them, times
    ``MODEL_RANKS_TWIN_MULTIPLE``, bounds each rank's logits block in
    both attention modes.  Returns the ranks' launches (their main
    path's, summed) and the phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ranks as rk
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.convert import param_tree
    from repro_torch.models.ranked import batch_rows
    from repro_torch.tree import Stacked, tree_map
    t_phase = time.perf_counter()
    cfg = get_config(MODEL_ARCH).scaled(num_layers=MODEL_RANKS_LAYERS)
    nums = {"stripes": stripe_checks(torch, dev, cfg, card)}
    log(f"model-ranks kernel 11 stripes [{card}]: "
        f"{json.dumps(nums['stripes'])}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    B, S = MODEL_RANKS_PREFILL
    P = MODEL_RANKS_DECODE["seq"]
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)

    def decode(m, dtype):
        cache = m.init_cache(B, P, dtype=dtype)
        outs = []
        for t in range(P):
            lg, cache = m.decode_step(cache, toks[:, t], t)
            outs.append(lg)
        return torch.stack(outs, dim=1)

    logits = model.apply({"tokens": toks})
    dec = decode(model, torch.bfloat16)
    twin = Model(cfg.scaled(dtype="float32"), device=dev)
    twin.load_state_dict(model.state_dict())
    bound_prefill = MODEL_RANKS_TWIN_MULTIPLE * logit_err(
        torch, logits, twin.apply({"tokens": toks}))
    bound_decode = MODEL_RANKS_TWIN_MULTIPLE * logit_err(
        torch, dec, decode(twin, torch.float32))
    del twin
    _free(torch)
    torch.cuda.synchronize()
    mesh = make_mesh(MODEL_RANKS_MESH, ("data", "model"))
    params = tree_map(lambda x: Stacked(p.detach() for p in x.parts)
                      if isinstance(x, Stacked) else x.detach(),
                      param_tree(model))
    specs = shd.param_specs(cfg, params, mesh)
    A, M = MODEL_RANKS_MESH
    Vl = cfg.padded_vocab // M
    rank_args = []
    for r in range(mesh.size):
        a, m = mesh.coords(r)
        r0, r1 = batch_rows(B, A, a)
        local = tree_map(lambda leaf, spec: shd.local_block(
            leaf, spec, mesh, (a, m)), params, specs)
        rank_args.append((cfg, local, toks, {
            "prefill": logits[r0:r1, :, m * Vl:(m + 1) * Vl],
            "decode": dec[r0:r1, :, m * Vl:(m + 1) * Vl]}))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="model_ranks_") as tmp:
        res = rk.launch(rank_model_body, mesh, rank_args,
                        init_file=os.path.join(tmp, "init"),
                        timeout=MODEL_RANKS_DEADLINE)
    nums["spawn_s"] = time.perf_counter() - t0
    nums.update(bound_prefill=bound_prefill, bound_decode=bound_decode)
    launches = None
    for x in res:
        log(f"model-ranks [{card}] rank at {tuple(x['coords'])}: "
            f"{json.dumps({k: x[k] for k in x if k != 'coords'})}")
        for mode in MODEL_RANKS_DECODE:
            got = x[mode]
            assert got["prefill_err"] <= bound_prefill, (x["coords"], mode,
                                                         got["prefill_err"])
            assert got["decode_err"] <= bound_decode, (x["coords"], mode,
                                                       got["decode_err"])
            assert got["flash_launches"] == cfg.num_layers, got
            assert not got["other_launches"], got
            assert got["op_paths"] == {"flash_attention": "cuda-kernel"}, got
            assert not any(k.startswith("masked") for k in got["routes"])
        launches = x["launches"] if launches is None else {
            k: launches[k] + x["launches"][k] for k in launches}
    nums["ranks"] = [{k: x[k] for k in ("coords", "peak_gb", "seq")}
                     for x in res]
    del rank_args, logits, dec, params, model
    _free(torch)
    torch.cuda.ipc_collect()
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"model-ranks [{card}]: logit bounds (2 x the one-card bf16 "
        f"distance from its fp32 twin) prefill {bound_prefill}, decode "
        f"{bound_decode}; worst rank prefill "
        f"{max(x[m]['prefill_err'] for x in res for m in MODEL_RANKS_DECODE)}"
        f", decode "
        f"{max(x[m]['decode_err'] for x in res for m in MODEL_RANKS_DECODE)}")
    log(f"phase model-ranks: {nums['phase_s']:.1f} s")
    return launches, nums


# the serve-ranks phase: ServeEngine on a RankModel over (data 2, model 2),
# one gloo rank a position on this card.  (a) qwen2-vl-7b at full width
# (M-RoPE, an embeddings input), depth cut to 2 of 28 layers (4 until the
# moe-ranks phase): a rank gathers every layer again at each decode step
# over gloo (1.1-1.9 s per GB on an H100 80GB HBM3 at 700 W, PERF.md §5),
# ~13 GB a step at 28 layers, ~1.7 GB at 4; its cache
# protected as launch.serve --protect protects it (RS(k=1, m=1) over
# "data", 256-byte pages) and decoded at temperature 1.0, a 4-token
# prompt and 8 steps (16 and 16 until the moe-ranks phase: each token is
# a forward that gathers every layer).  (b) the
# attention options at starcoder2-3b's widths: layers "AW" with a
# 1,024-slot window, the int8 KV cache, both softcaps, 2 layers
SERVE_RANKS_ARCH = "qwen2-vl-7b"
SERVE_RANKS_LAYERS = 2
SERVE_RANKS_MESH = (2, 2)
SERVE_RANKS_PREFILL = (2, 2048)
SERVE_RANKS_PROMPT = 4
SERVE_RANKS_STEPS = 8
SERVE_RANKS_MAX_LEN = 2048
SERVE_RANKS_EC = dict(k=1, m=1, page_size=256)
SERVE_RANKS_SEED = 26
SERVE_RANKS_OPTIONS = dict(num_layers=2, layer_pattern="AW",
                           local_window=1024, kv_cache_dtype="int8",
                           attn_logit_softcap=50.0, logit_softcap=30.0)
SERVE_RANKS_OPTIONS_STEPS = 8
SERVE_RANKS_DEADLINE = 900.0


def _bytes_of(torch, tree) -> dict:
    """A tree's leaves' bytes by path, host arrays (``Stacked`` leaves
    stacked; a rank answers with arrays, not tensors: it exits right
    after answering), for the parent to reassemble."""
    from repro_torch.tree import leaves_with_path, materialize, path_str
    return {path_str(k): materialize(t).contiguous().view(torch.uint8).cpu()
            .numpy() for k, t in leaves_with_path(tree)}


def _serve_protected(torch, model, emb, mesh, ops, sent):
    """Part (a)'s session on one rank: the prompt's token-by-token
    prefill, ``protect_cache``, ``SERVE_RANKS_STEPS`` decode steps at
    temperature 1.0, ``refresh_cache_parity``, ``recover_cache_pages(0)``
    (each EC call timed and its bytes noted apart by ``_rank_timed``),
    and the faulted control; the sampler's gathers are noted apart."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.ecstore import ECConfig
    from repro_torch.kernels import launch_counts
    from repro_torch.serve.engine import ServeEngine

    def note(part):
        def add(n, kind):
            sent[part][kind] = sent[part].get(kind, 0) + n
        return add
    sample = model.sample

    def sample_noted(*args):
        with recording(note("sampler")):
            return sample(*args)
    model.sample = sample_noted
    B = emb.shape[0]
    eng = ServeEngine(model, max_len=SERVE_RANKS_MAX_LEN, batch_size=B,
                      device=emb.device)
    eng.generator.manual_seed(SERVE_RANKS_SEED)
    out = {}
    with recording(note("serve")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = model.argmax(eng.prefill(
            {"embeddings": emb[:, :SERVE_RANKS_PROMPT]}))
        torch.cuda.synchronize()
        out["prompt_s_per_step"] = (time.perf_counter() - t0) / \
            SERVE_RANKS_PROMPT
        specs = shd.cache_specs(model.cfg, eng.cache_shapes(), mesh)
        _rank_timed(torch, ops, "create", eng.protect_cache, mesh, specs,
                    ECConfig(**SERVE_RANKS_EC))
        old = eng.cache_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.decode(SERVE_RANKS_STEPS, temperature=1.0,
                         first_tokens=first)
        torch.cuda.synchronize()
        out["decode_s_per_step"] = (time.perf_counter() - t0) / \
            SERVE_RANKS_STEPS
        _rank_timed(torch, ops, "refresh", eng.refresh_cache_parity, old)
        rebuilt = _rank_timed(torch, ops, "rebuild0",
                              eng.recover_cache_pages, 0)
    model.sample = sample
    out["main_launches"] = launch_counts()
    live = eng.ec_store.local_pages(eng.cache_tree())
    out["stale"] = _differ(torch, eng.ec_parity,
                           eng.ec_store.encode(eng.cache_tree()))
    faulted = eng.ec_parity.clone()
    faulted.view(-1)[0] ^= 1
    out["faulted_differs"] = _differ(torch, eng.ec_store.reconstruct(
        eng.cache_tree(), faulted, 0), rebuilt)
    out.update(tokens=np_tokens(res.tokens), first=first.cpu().tolist(),
               pages=live.cpu().numpy(), rebuilt=rebuilt.cpu().numpy(),
               cache=_bytes_of(torch, eng.cache_tree()),
               cache_len=eng.cur_len,
               ec_paths=dict(model.comms.data.op_paths))
    return out


def np_tokens(tokens):
    """A (B, steps) token array as nested lists."""
    return [[int(t) for t in row] for row in tokens]


def serve_rank_body(comm, cfg, local, batch, want, cfg_b, local_b, toks_b,
                    fed_b, want_b):
    """Serve-ranks phase, one rank: (a) ``RankModel`` of ``cfg`` on the
    rank's blocks (shared with the parent), after a 64-token warm-up:
    ``apply`` on the whole batch (its logits block against the one-card
    model's, ``want["prefill"]``; its bytes by kind), the protected
    session (``_serve_protected``) and the rank sampler on its block of
    the one-card logits ``want["sample"]``; (b) ``RankModel`` of
    ``cfg_b``: ``apply`` on ``toks_b`` and the decode steps fed
    ``fed_b``, against the one-card model's (``want_b``)."""
    import torch
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.ranks import rank_comms
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layers
    from repro_torch.models.ranked import RankModel
    torch.cuda.set_device(0)
    layers.set_activation_mesh(rank_comms(comm))
    out = {"coords": comm.coords}
    sent = {"prefill": {}, "serve": {}, "sampler": {}, "b_prefill": {},
            "b_decode": {}}

    def note(part):
        def add(n, kind):
            sent[part][kind] = sent[part].get(kind, 0) + n
        return add
    model = RankModel(cfg, local)
    model.apply({k: v[..., :64, :] if k == "embeddings" else v[..., :64]
                 for k, v in batch.items()})           # warm-up
    layers.reset_op_paths()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(note("prefill")):
        logits = model.apply(batch)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_err"] = float((logits.float() - want["prefill"].float())
                               .abs().max())
    out["prefill_launches"] = launch_counts()
    out["prefill_routes"] = dict(layers.OP_PATHS)
    del logits
    ops = {}
    out.update(_serve_protected(torch, model, batch["embeddings"],
                                comm.mesh, ops, sent))
    out["ops"] = ops
    gen = torch.Generator(device=want["sample"].device)
    gen.manual_seed(SERVE_RANKS_SEED)
    out["sampler_tokens"] = model.sample(want["sample"].contiguous(), 1.0,
                                         gen).cpu().tolist()
    out["op_paths"] = dict(model.op_paths)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # (b) the attention options
    model_b = RankModel(cfg_b, local_b)
    layers.reset_op_paths()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(note("b_prefill")):
        logits = model_b.apply({"tokens": toks_b})
    torch.cuda.synchronize()
    out["b_prefill_s"] = time.perf_counter() - t0
    out["b_prefill_err"] = float((logits.float() - want_b["prefill"].float())
                                 .abs().max())
    del logits
    cache = model_b.init_cache(toks_b.shape[0], len(fed_b),
                               dtype=torch.bfloat16)
    err = 0.0
    t0 = time.perf_counter()
    with recording(note("b_decode")):
        for t, tok in enumerate(fed_b):
            lg, cache = model_b.decode_step(cache, tok, t)
            err = max(err, float((lg.float() - want_b["decode"][:, t]
                                  .float()).abs().max()))
    torch.cuda.synchronize()
    out["b_decode_s_per_step"] = (time.perf_counter() - t0) / len(fed_b)
    out.update(b_decode_err=err, b_routes=dict(layers.OP_PATHS),
               b_op_paths=dict(model_b.op_paths), sent=sent,
               b_launches=launch_counts())
    layers.set_activation_mesh(None)
    return out


def stacked_store(torch, dev, cfg, caches, coords, batch, max_len, dtype,
                  mesh, ec):
    """The stacked one-card store over the whole serving cache of ``cfg``
    (``batch`` rows, ``max_len`` positions, ``dtype``), assembled from
    the ranks' blocks (``caches``: each rank's ``_bytes_of`` of its cache
    tree, at ``coords``), protected by ``ec`` over ``mesh``'s data axis:
    every position's pages and every position's rebuild of data
    position 0, stacked."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.ecstore import ECConfig, ECStateStore
    from repro_torch.kernels import dispatch
    from repro_torch.models import Model
    from repro_torch.tree import leaves_with_path, path_str, tree_map
    with dispatch.dry_run():
        meta = Model(cfg, device="meta")
    shapes = meta.cache_tree(meta.init_cache(batch, max_len, dtype))
    cspecs = shd.cache_specs(cfg, shapes, mesh)
    gathered = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=dev), shapes)
    flat_specs = {path_str(k): s for k, s in leaves_with_path(cspecs)}
    for cache, at in zip(caches, coords):
        for path, leaf in leaves_with_path(gathered):
            name = path_str(path)
            view = shd.local_view(leaf, flat_specs[name], mesh)
            view[at].view(torch.uint8).copy_(torch.from_numpy(cache[name]))
    store = ECStateStore(mesh, cspecs, ECConfig(**ec))
    return (store.local_pages(gathered),
            store.reconstruct(gathered, store.encode(gathered), 0))


def _serve_ranks_reference(torch, dev, cfg, batch, card):
    """Part (a)'s one-card model on the seed's weights: its bf16 prefill
    logits, the bound (``MODEL_RANKS_TWIN_MULTIPLE`` times their distance
    from an fp32 twin's), the one-card engine's tokens sampled as the
    ranks sample them, and the one-card sampler's tokens on the last
    position's logits."""
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_RANKS_SEED)
    model = Model(cfg, device=dev).init(gen)
    logits = model.apply(batch)
    twin = Model(cfg.scaled(dtype="float32"), device=dev)
    twin.load_state_dict(model.state_dict())
    bound = MODEL_RANKS_TWIN_MULTIPLE * logit_err(
        torch, logits, twin.apply(batch))
    del twin
    _free(torch)
    eng = ServeEngine(model, max_len=SERVE_RANKS_MAX_LEN,
                      batch_size=batch["embeddings"].shape[0], device=dev)
    eng.generator.manual_seed(SERVE_RANKS_SEED)
    first = model.argmax(eng.prefill(
        {"embeddings": batch["embeddings"][:, :SERVE_RANKS_PROMPT]}))
    tokens = eng.decode(SERVE_RANKS_STEPS, temperature=1.0,
                        first_tokens=first).tokens
    del eng
    sample = logits[:, -1].contiguous()
    gen.manual_seed(SERVE_RANKS_SEED)
    sampled = Model.sample(sample, 1.0, gen).cpu().tolist()
    return model, logits, bound, np_tokens(tokens), sample, sampled


def _options_reference(torch, dev, cfg, toks):
    """Part (b)'s one-card model: bf16 prefill logits, the greedy decode
    from the first token (the tokens fed, the logits), and the bounds
    from an fp32 twin fed the same tokens."""
    from repro_torch.models import Model
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_RANKS_SEED + 1)
    model = Model(cfg, device=dev).init(gen)
    B = toks.shape[0]

    def decode(m, fed=None):
        cache = m.init_cache(B, SERVE_RANKS_OPTIONS_STEPS,
                             dtype=torch.bfloat16)
        tok, feed, outs = toks[:, 0], [], []
        for t in range(SERVE_RANKS_OPTIONS_STEPS):
            tok = tok if fed is None else fed[t]
            feed.append(tok)
            lg, cache = m.decode_step(cache, tok, t)
            outs.append(lg)
            tok = m.argmax(lg)
        return feed, torch.stack(outs, dim=1)
    logits = model.apply({"tokens": toks})
    fed, dec = decode(model)
    twin = Model(cfg.scaled(dtype="float32"), device=dev)
    twin.load_state_dict(model.state_dict())
    bounds = {"prefill": MODEL_RANKS_TWIN_MULTIPLE * logit_err(
                  torch, logits, twin.apply({"tokens": toks})),
              "decode": MODEL_RANKS_TWIN_MULTIPLE * logit_err(
                  torch, dec, decode(twin, fed)[1])}
    del twin
    _free(torch)
    return model, logits, fed, dec, bounds


def run_serve_ranks(np, torch, dev, card):
    """``ServeEngine`` across ranks: four gloo ranks over (data 2, model
    2), each a ``RankModel`` on its blocks of the parent's one-card model
    (shared, not copied).  (a) qwen2-vl-7b cut to ``SERVE_RANKS_LAYERS``
    layers: ``apply`` on 2 x 2,048 embeddings with three M-RoPE position
    streams, each rank's logits block within the twin-based bound of the
    one-card bf16 model's and its bytes by kind equal to
    ``dryrun.count_rank_forward``'s; a protected session (RS(1,1) over
    "data"): its pages equal the stacked one-card store's over the cache
    gathered from the ranks, the parity a fresh encode after the refresh,
    the rebuilt position 0 its live pages, and a flipped parity byte must
    change the rebuild; the rank sampler on the one-card logits gives the
    one-card sampler's tokens, the same on every rank; the share of
    sampled tokens equal to the one-card engine's is printed.  (b) the
    options config: its prefill (the masked stripes) and decode (the int8
    ring) logits within their twin-based bounds.  Kernels 11 and 1 must
    launch on every rank, the card's paths only.  Returns the ranks'
    main-path launches, summed, and the phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ranks as rk
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import param_tree
    from repro_torch.models.ranked import batch_rows
    from repro_torch.tree import Stacked, tree_map
    t_phase = time.perf_counter()
    full = get_config(SERVE_RANKS_ARCH)
    cfg = full.scaled(num_layers=SERVE_RANKS_LAYERS)
    log(f"serve-ranks: {SERVE_RANKS_ARCH} at full width (d_model "
        f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), depth cut "
        f"to {cfg.num_layers} of {full.num_layers} layers")
    B, S = SERVE_RANKS_PREFILL
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_RANKS_SEED + 2)
    emb = torch.randn((B, S, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    # three distinct (t, h, w) position streams
    positions = torch.stack([torch.sort(torch.randint(
        0, S, (B, S), generator=gen, device=dev), dim=1).values
        for _ in range(3)])
    batch = {"embeddings": emb, "positions": positions}
    model, logits, bound, one_tokens, sample, one_sampled = \
        _serve_ranks_reference(torch, dev, cfg, batch, card)
    cfg_b = get_config(MODEL_ARCH).scaled(**SERVE_RANKS_OPTIONS)
    toks_b = torch.randint(0, cfg_b.vocab_size, (B, S), generator=gen,
                           device=dev)
    model_b, logits_b, fed_b, dec_b, bounds_b = _options_reference(
        torch, dev, cfg_b, toks_b)
    nums = {"bound_prefill": bound, "options_bounds": bounds_b,
            "one_card_tokens": one_tokens, "one_card_sampler": one_sampled}
    log(f"serve-ranks [{card}] one-card: bound {bound}, options bounds "
        f"{json.dumps(bounds_b)}")
    mesh = make_mesh(SERVE_RANKS_MESH, ("data", "model"))
    A, M = SERVE_RANKS_MESH

    def blocks(m, coords):
        params = tree_map(lambda x: Stacked(p.detach() for p in x.parts)
                          if isinstance(x, Stacked) else x.detach(),
                          param_tree(m))
        specs = shd.param_specs(m.cfg, params, mesh)
        return tree_map(lambda leaf, spec: shd.local_block(
            leaf, spec, mesh, coords), params, specs)
    rank_args = []
    for r in range(mesh.size):
        a, m = mesh.coords(r)
        r0, r1 = batch_rows(B, A, a)
        Vl, Vb = cfg.padded_vocab // M, cfg_b.padded_vocab // M
        rank_args.append((
            cfg, blocks(model, (a, m)), batch,
            {"prefill": logits[r0:r1, :, m * Vl:(m + 1) * Vl],
             "sample": sample[r0:r1, m * Vl:(m + 1) * Vl]},
            cfg_b, blocks(model_b, (a, m)), toks_b, fed_b,
            {"prefill": logits_b[r0:r1, :, m * Vb:(m + 1) * Vb],
             "decode": dec_b[r0:r1, :, m * Vb:(m + 1) * Vb]}))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serve_ranks_") as tmp:
        res = rk.launch(serve_rank_body, mesh, rank_args,
                        init_file=os.path.join(tmp, "init"),
                        timeout=SERVE_RANKS_DEADLINE)
    nums["spawn_s"] = time.perf_counter() - t0
    del rank_args, logits, logits_b, dec_b, model, model_b
    _free(torch)
    torch.cuda.ipc_collect()
    stacked_pages, stacked_rebuilt = stacked_store(
        torch, dev, cfg, [x["cache"] for x in res],
        [tuple(x["coords"]) for x in res], B, SERVE_RANKS_MAX_LEN,
        torch.bfloat16, mesh, SERVE_RANKS_EC)
    launches, counted = None, {}
    for x in res:
        at = tuple(x["coords"])
        with dispatch.dry_run():
            counted[at] = {
                "a": dryrun.count_rank_forward(
                    cfg, dryrun.ShapeSpec("x", "prefill", S, B), mesh,
                    at)["collectives"],
                "b": dryrun.count_rank_forward(
                    cfg_b, dryrun.ShapeSpec("x", "prefill", S, B), mesh,
                    at)["collectives"]}
        pages = torch.from_numpy(x["pages"]).to(dev)
        rebuilt = torch.from_numpy(x["rebuilt"]).to(dev)
        pages_diff = _differ(torch, pages, stacked_pages[at])
        rebuilt_diff = _differ(torch, rebuilt, stacked_rebuilt[at])
        live0 = _differ(torch, rebuilt, stacked_pages[0, at[1]])
        same = sum(int(a == b) for ra, rb in zip(x["tokens"], one_tokens)
                   for a, b in zip(ra, rb))
        x.update(pages_diff=pages_diff, rebuilt_diff=rebuilt_diff,
                 rebuilt_vs_live=live0,
                 sampled_share=same / (B * SERVE_RANKS_STEPS))
        log(f"serve-ranks [{card}] rank at {at}: " + json.dumps(
            {k: x[k] for k in x if k not in ("coords", "pages", "rebuilt",
                                             "cache")}))
        assert x["prefill_err"] <= bound, (at, x["prefill_err"], bound)
        assert x["sent"]["prefill"] == counted[at]["a"], (
            at, x["sent"]["prefill"], counted[at]["a"])
        assert x["sent"]["b_prefill"] == counted[at]["b"], (
            at, x["sent"]["b_prefill"], counted[at]["b"])
        assert x["prefill_launches"]["flash_attention"] == cfg.num_layers, x
        assert x["op_paths"] == {"flash_attention": "cuda-kernel"}, x
        assert set(x["ec_paths"].values()) == {"cuda-kernel"}, x["ec_paths"]
        assert not any(k.startswith("masked")
                       for k in x["prefill_routes"]), x["prefill_routes"]
        assert pages_diff == 0 and rebuilt_diff == 0 and live0 == 0, x
        assert x["stale"] == 0, x["stale"]
        assert x["faulted_differs"] > 0, "a flipped parity byte rebuilds"
        assert x["cache_len"] == SERVE_RANKS_PROMPT + SERVE_RANKS_STEPS
        assert x["sampler_tokens"] == one_sampled, (x["sampler_tokens"],
                                                    one_sampled)
        assert x["tokens"] == res[0]["tokens"], "ranks sampled apart"
        assert x["b_prefill_err"] <= bounds_b["prefill"], x["b_prefill_err"]
        assert x["b_decode_err"] <= bounds_b["decode"], x["b_decode_err"]
        assert x["b_routes"].get("masked_blockwise:torch") == \
            cfg_b.num_layers, x["b_routes"]
        assert not any(k.startswith("flash") for k in x["b_routes"])
        assert x["b_op_paths"] == {}, x["b_op_paths"]
        assert not any(x["b_launches"].values()), x["b_launches"]
        n = x["main_launches"]
        assert n["flash_attention"] == cfg.num_layers, n
        assert n["gf_matmul_batched"] > 0, n
        launches = n if launches is None else {k: launches[k] + n[k]
                                               for k in launches}
    nums["ranks"] = [{k: x[k] for k in x if k not in (
        "pages", "rebuilt", "cache", "tokens")} for x in res]
    nums["ranks_tokens"] = res[0]["tokens"]
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"serve-ranks [{card}]: prefill s a rank "
        f"{[round(x['prefill_s'], 3) for x in res]}, decode s a step a rank "
        f"{[round(x['decode_s_per_step'], 3) for x in res]}, EC ms "
        f"(create / refresh / rebuild) "
        f"{[[round(1e3 * x['ops'][o]['s'], 1) for o in ('create', 'refresh', 'rebuild0')] for x in res]}"
        f", kernel-11 / kernel-1 launches a rank "
        f"{[(x['main_launches']['flash_attention'], x['main_launches']['gf_matmul_batched']) for x in res]}"
        f", peak GB a rank {[round(x['peak_gb'], 3) for x in res]}, "
        f"sampled tokens equal to the one-card engine's "
        f"{[x['sampled_share'] for x in res]}")
    log(f"phase serve-ranks: {nums['phase_s']:.1f} s")
    return launches, nums


# the train-ranks phase: starcoder2-3b trained over (data 2, model 2), as
# launch.train --ec trains with its defaults (--ec-k 2 --ec-m 1), held
# against the one-card bf16 step 1 on the same weights and batch.  Depth
# is cut to 24 of 30 layers: at 30 the four ranks' blocks, gradients,
# fp32 moments, EC pages, parity and the fold's scaled classes (~17 GiB
# a rank) and five CUDA contexts outgrew the card's 79.18 GiB while the
# EC copy was created (out of memory on an H100 80GB HBM3, 700 W); a
# layer costs ~2.1 GiB over the four ranks.  Since the recurrent-ranks
# phase it is 12 (a step takes 15.0-17.4 s a rank at 24 over gloo, and
# chip_smoke took 1,192.3 s on a slow host with 24), and since the
# moe-ranks phase 4 (chip_smoke took 1,180.8-1,233.4 s on slow hosts
# with 8 and 12)
TRAIN_RANKS_LAYERS = 4
TRAIN_RANKS_MESH = (2, 2)
TRAIN_RANKS_STEPS = 2
TRAIN_RANKS_EC = dict(k=2, m=1)
TRAIN_RANKS_REBUILT = 0          # the data position rebuilt after the run
TRAIN_RANKS_DEADLINE = 900.0


def attn_block_errors(grads, want) -> dict:
    """Per attention weight, the largest over the layers of |g - g_1| /
    |g_1| of a rank's gradient block against the one-card step's block."""
    return {w: max(float((g[w].float() - p[w].float()).norm()
                         / p[w].float().norm()) for g, p in zip(grads, want))
            for w in ATTN_WEIGHTS}


def rank_attn_grads(params) -> list:
    """The attention weight gradients of a rank's blocks, per layer."""
    attn = params["blocks"][0]["attn"]
    return [{w: attn[w].parts[r].grad for w in ATTN_WEIGHTS}
            for r in range(len(attn["wq"].parts))]


def train_rank_body(comm, cfg, want_attn, steps):
    """Train-ranks phase, one rank: its blocks of the seed's weights drawn
    on the card (``ranked.init_blocks``, the parent's one-card model's
    numbers, as ``launch.train --mesh`` draws them); first the faulted
    control, one forward and backward with every gradient reduce-scatter
    keeping the next index's block (its attention gradients' distance
    from the one-card step's, ``want_attn``); then
    ``launch.train.train_on_rank`` (AdamW, the EC copy) for ``steps``
    steps with the launch counts from 0: per step the loss, the norm,
    the seconds, the bytes sent by kind and whether the parity equals a
    fresh encode of the new blocks; step 1's attention gradients'
    distance; the launches, ``op_paths``, a rebuild of data position
    ``TRAIN_RANKS_REBUILT`` (byte for byte on its ranks), the dry run's
    count of the same step at the rank's coordinates and the peak."""
    import torch
    from repro_torch.distributed import ranks as rk
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.ecstore import ECConfig
    from repro_torch.kernels import (dispatch, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import train_on_rank
    from repro_torch.models import layers
    from repro_torch.models.ranked import RankModel, init_blocks
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_rank_loss_fn, value_and_grad
    from repro_torch.tree import leaves, tensors
    torch.cuda.set_device(0)
    comms = rk.rank_comms(comm)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    own = init_blocks(cfg, comm.mesh, comm.coords, gen)
    torch.cuda.synchronize()
    out = {"coords": comm.coords, "init_s": time.perf_counter() - t0}
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    batch0 = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0), device=dev).batch(0)

    # the faulted control: a reduce-scatter that keeps the wrong block
    real = rk.RankComm.reduce_scatter
    rk.RankComm.reduce_scatter = lambda self, x: real(
        self, x.roll(-1, dims=0))
    try:
        model = RankModel(cfg, own, comms)
        with torch.autograd.set_multithreading_enabled(False):
            value_and_grad(make_rank_loss_fn(model), own, batch0)
        out["control_attn_err"] = attn_block_errors(rank_attn_grads(own),
                                                    want_attn)
    finally:
        rk.RankComm.reduce_scatter = real
    for leaf in leaves(own):
        for t in tensors(leaf):
            t.grad = None
    del model
    torch.cuda.empty_cache()

    opt = make_optimizer("adamw", lr=1e-3,
                         warmup_steps=min(20, steps // 5 + 1),
                         total_steps=steps)
    seen = {"steps": []}

    def apply(grads, state, params, scale, place=None):
        if "attn_err" not in seen:
            seen["attn_err"] = attn_block_errors(rank_attn_grads(params),
                                                 want_attn)
        return opt.apply(grads, state, params, scale, place=place)

    sent: dict = {}
    extra = dict(launches={})

    def observe(step, st):
        torch.cuda.synchronize()
        now = time.perf_counter()
        before = launch_counts()
        with recording(lambda n, kind: None):     # a check, not the step
            fresh = st["ec"].store.encode(st["params"])
            stale = _differ(torch, fresh, st["ec"].parity)
            del fresh
        torch.cuda.synchronize()
        for k, v in launch_counts().items():
            extra["launches"][k] = extra["launches"].get(k, 0) \
                + v - before[k]
        seen["steps"].append(dict(
            loss=float(st["metrics"]["loss"]),
            grad_norm=float(st["metrics"]["grad_norm"]),
            s=now - seen["t"], sent=dict(sent), stale=stale))
        seen.update(ec=st["ec"], params=st["params"], model=st["model"])
        seen["t"] = time.perf_counter()

    layers.reset_op_paths()
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen["t"] = t0 = time.perf_counter()
    with recording(lambda n, kind: sent.__setitem__(
            kind, sent.get(kind, 0) + n)):
        train_on_rank(comms, cfg, own, steps=steps, batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, optimizer=opt._replace(apply=apply),
                      ec=True, ec_k=TRAIN_RANKS_EC["k"],
                      ec_m=TRAIN_RANKS_EC["m"], observe=observe,
                      log=lambda *a: None)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    launches = launch_counts()
    out["launches"] = {k: v - extra["launches"].get(k, 0)
                       for k, v in launches.items()}
    model, ec, params = seen["model"], seen["ec"], seen["params"]
    out["op_paths"] = dict(model.op_paths, **comms.data.op_paths)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    steps_out = seen["steps"]            # step 1's bytes: the EC encode's too
    out["steps"] = [dict(s, sent={k: v - (steps_out[i - 1]["sent"].get(k, 0)
                                          if i else 0)
                                  for k, v in s["sent"].items()})
                    for i, s in enumerate(steps_out)]
    out["attn_err"] = seen["attn_err"]
    # a lost data position rebuilt from the others and the parity
    rec = ec.reconstruct(params, TRAIN_RANKS_REBUILT)
    torch.cuda.synchronize()
    out["rebuilt"] = (None if comm.index != TRAIN_RANKS_REBUILT else
                      _differ(torch, rec, ec.store.local_pages(params)))
    del rec
    t0 = time.perf_counter()
    with dispatch.dry_run():
        counted = dryrun.count_rank_train(
            cfg, dryrun.ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH),
            comm.mesh, comm.coords,
            ec=ECConfig(page_size=256, **TRAIN_RANKS_EC))
    out["counted"] = counted["collectives"]
    out["count_s"] = time.perf_counter() - t0
    return out


def run_train_ranks(np, torch, dev, card):
    """starcoder2-3b cut to ``TRAIN_RANKS_LAYERS`` layers, trained over
    (data 2, model 2), one rank a position (``launch.train.train_on_rank``:
    ``RankModel`` under autograd, AdamW on the rank's blocks, an
    ``ECCheckpoint(comm=...)`` of them), on the train phase's seed and
    batch.  The parent measures the train phase's bounds on the cut model
    (``step1_checks``: twice bf16 plain's distance from its fp32 twin),
    runs the one-card bf16 step 1 (loss, norm, the attention weight
    gradients) and frees it before the spawn; every rank's step-1 loss,
    norm and attention gradient blocks must hold to those bounds, the
    faulted control
    (a reduce-scatter keeping the wrong block) must miss them, the parity
    must equal a fresh encode after each step, the rebuilt position must
    equal its pages, kernels 11 and 1 must launch on every rank through
    the card, and each step's bytes sent by kind must equal
    ``dryrun.count_rank_train``.  Returns the ranks' launches, summed,
    and the phase's numbers."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import ranks as rk
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.convert import param_tree
    t_phase = time.perf_counter()
    cfg = get_config(MODEL_ARCH).scaled(num_layers=TRAIN_RANKS_LAYERS)
    assert cfg.remat == "full" and cfg.attn_parallel == "seq", cfg
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH, seed=0),
                        device=dev).batch(0)
    bounds = step1_checks(torch, model, batch, card, "train-ranks")["bounds"]
    loss, norm, attn = step1_grads(torch, model, batch, fa,
                                   "flash_attention_backward", None)
    one = dict(loss=loss, grad_norm=norm)
    mesh = make_mesh(TRAIN_RANKS_MESH, ("data", "model"))
    specs = shd.param_specs(cfg, param_tree(model), mesh)
    del model, batch                           # the ranks draw their own
    _free(torch)
    log(f"train-ranks [{card}] one-card bf16 step 1 ({cfg.num_layers} "
        f"layers): {json.dumps(one)}; bounds: {json.dumps(bounds)}")
    attn_specs = {w: shd.P(*specs["blocks"][0]["attn"][w][1:])
                  for w in ATTN_WEIGHTS}
    rank_args = []
    for r in range(mesh.size):
        coords = mesh.coords(r)
        want = [{w: shd.local_block(g[w], attn_specs[w], mesh, coords)
                 for w in ATTN_WEIGHTS} for g in attn]
        rank_args.append((cfg, want, TRAIN_RANKS_STEPS))
    # the card's memory in use while the ranks run (every process's)
    used, stop = [0], threading.Event()

    def poll():
        while not stop.is_set():
            free, total = torch.cuda.mem_get_info(dev)
            used[0] = max(used[0], total - free)
            stop.wait(0.2)
    watcher = threading.Thread(target=poll, daemon=True)
    watcher.start()
    # four ranks' fp32 moments share the card: the ranks' allocators map
    # their segments as they grow rather than round them into blocks
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="train_ranks_") as tmp:
            res = rk.launch(train_rank_body, mesh, rank_args,
                            init_file=os.path.join(tmp, "init"),
                            timeout=TRAIN_RANKS_DEADLINE)
    finally:
        stop.set()
        watcher.join()
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    nums = dict(one_card=one, bounds=bounds,
                spawn_s=time.perf_counter() - t0, card_peak_gb=used[0] / 1e9)
    launches = None
    for x in res:
        log(f"train-ranks [{card}] rank at {tuple(x['coords'])}: "
            f"{json.dumps({k: x[k] for k in x if k != 'coords'})}")
        s1 = x["steps"][0]
        loss_err = abs(s1["loss"] - one["loss"])
        norm_err = abs(s1["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
        x.update(step1_loss_err=loss_err, step1_grad_norm_rel_err=norm_err)
        assert loss_err <= bounds["loss"], (x["coords"], loss_err)
        assert norm_err <= bounds["norm"], (x["coords"], norm_err)
        for w in ATTN_WEIGHTS:
            assert x["attn_err"][w] <= bounds["attn"][w], (x["coords"], w)
        assert any(x["control_attn_err"][w] > bounds["attn"][w]
                   for w in ATTN_WEIGHTS), \
            f"the faulted reduce-scatter passes: {x['control_attn_err']}"
        assert all(s["stale"] == 0 for s in x["steps"]), x["steps"]
        assert x["rebuilt"] in (None, 0), x["rebuilt"]
        assert x["steps"][1]["sent"] == x["counted"], (x["coords"],
                                                        x["steps"][1]["sent"],
                                                        x["counted"])
        n = x["launches"]
        assert n["flash_attention"] == 2 * cfg.num_layers * \
            TRAIN_RANKS_STEPS, n
        assert n["gf_matmul_batched"] > 0, n
        assert x["op_paths"]["flash_attention"] == "cuda-kernel", x
        assert set(x["op_paths"].values()) == {"cuda-kernel"}, x["op_paths"]
        launches = n if launches is None else {k: launches[k] + n[k]
                                               for k in launches}
    assert any(x["rebuilt"] == 0 for x in res)
    nums["ranks"] = [{k: x[k] for k in (
        "coords", "peak_gb", "init_s", "train_s", "count_s", "attn_err",
        "control_attn_err", "step1_loss_err", "step1_grad_norm_rel_err")}
        | {"steps": [{k: s[k] for k in ("loss", "grad_norm", "s", "sent")}
                     for s in x["steps"]],
           "flash_launches": x["launches"]["flash_attention"],
           "ec_launches": x["launches"]["gf_matmul_batched"]}
        for x in res]
    del rank_args, attn
    _free(torch)
    torch.cuda.ipc_collect()
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"train-ranks [{card}]: seconds a step a rank (step 2) "
        f"{[round(x['steps'][1]['s'], 4) for x in res]}, kernel-11 "
        f"launches a rank {[x['launches']['flash_attention'] for x in res]}"
        f", peak GB a rank {[round(x['peak_gb'], 3) for x in res]}, the "
        f"card's {nums['card_peak_gb']:.3f} GB")
    log(f"phase train-ranks: {nums['phase_s']:.1f} s")
    return launches, nums


# the recurrent-ranks phase: the recurrent layer kinds over (data 2,
# model 2), four gloo ranks on this card, each holding its blocks of the
# parent's one-card models (shared, not copied).  (a) recurrentgemma-2b
# at full width, one "RRW" unit (3 of 26 layers: a rank gathers its
# whole model, the 655 M-element table twice, at every decode step over
# gloo); (b) mamba2-370m at full width, 12 of 48 layers (since the
# moe-ranks phase, for the script's time; the greedy sessions 4 steps, 8
# before). The prefill runs in bf16, the main path; the protected greedy
# session runs on the fp32 twin of the same weights, whose tokens the
# one-card fp32 engine's must equal: in bf16 the ranks' and the one
# card's logits sit a few hundredths apart (their sums round in another
# order) and near-tied greedy tokens flip (vocabularies of 256,000 and
# 50,280 random-weight logits); training runs in bf16 with the arch's
# optimizer, adamw8bit or adafactor
RECURRENT_RANKS = (("recurrentgemma-2b", 3, "adamw8bit"),
                   ("mamba2-370m", 12, "adafactor"))
RECURRENT_RANKS_MESH = (2, 2)
RECURRENT_RANKS_PREFILL = (2, 2048)
RECURRENT_RANKS_PROMPT = 1
RECURRENT_RANKS_STEPS = 4
RECURRENT_RANKS_EC = dict(k=1, m=1, page_size=256)
RECURRENT_RANKS_TRAIN_STEPS = 2
RECURRENT_RANKS_SEED = 27
RECURRENT_RANKS_DEADLINE = 900.0
# the mla-ranks phase: minicpm3-4b's MLA layers over (data 2, model 2),
# as the recurrent-ranks phase runs its archs (the same sizes, seed and
# checks): full width, depth cut to 2 of 62 layers (every decode step
# gathers every layer over gloo; 4 until the moe-ranks phase), AdamW (its
# moments are blocks of the parameters', so step 1's state is not
# compared whole)
MLA_RANKS = (("minicpm3-4b", 2, "adamw"),)
# the mla-ranks phase, part (b): minicpm3-4b on the production meshes'
# model axis, 16 gloo ranks over (data 1, model 16), whose 16 model
# positions do not divide its 40 heads (``param_specs`` leaves the head
# leaves whole on every position and splits ``wo`` by flat rows, 2.5
# heads a position), after part (a)'s (2, 2) spawn: full width, 1 of 62
# layers, a bf16 prefill of 2 x 512, a protected greedy fp32 session of
# 2 steps into a cache of 32 slots (2 a model position: most slices hold
# no valid slot), RS(1,1) over a data column of one position (the
# store's wrapped roles), one bf16 AdamW step at B 2 x S 512; at most 90
# s with the spawn
MLA_WIDE = (("minicpm3-4b", 1, "adamw"),)
# the moe-ranks phase: the MoE archs' experts over (data 2, model 2).
# (a) kimi-k2-1t-a32b at full width, 1 of 61 layers (one layer holds
# 43.50 GB of bf16 weights), bf16: a prefill of 2 x 256 tokens (cap 7:
# assignments drop) against the parent's one-card model, then one
# protected decode step, a one-token prompt's (ServeEngine prefills
# token by token: a longer prompt costs a forward a token), into a cache
# of 2 slots (1 a model position) protected while empty.  A rank sends
# 10.87 GB a forward (its 192 experts' data halves, 8.46 GB, the two
# fp32 tables' blocks, 2.35 GB, attention and router 0.07 GB), two in
# all.  An fp32 twin of the layer does not fit the card beside it, so
# the one card's bf16 routes are the reference and near-tie flips are
# explained (``settled_tokens``).  (b) both MoE archs at their reduced
# configs in fp32, as recurrent-ranks runs its archs (prefill 2 x 2,048,
# 8 greedy protected steps, two AdamW steps): routes, drop set and
# tokens exact; the logits within MOE_RANKS_FP32_TOL of the one card's
# (the CPU tests read 2.4e-7 at the reduced size; their bound is 2e-5 +
# 1e-4 relative)
MOE_RANKS_ARCH = "kimi-k2-1t-a32b"
MOE_RANKS_LAYERS = 1
MOE_RANKS_PREFILL = (2, 256)
MOE_RANKS_MAX_LEN = 2
MOE_RANKS_STEPS = 8
MOE_RANKS_SEED = 30
MOE_RANKS_DEADLINE = 900.0
MOE_RANKS_REDUCED = (("llama4-maverick-400b-a17b", None, "adamw"),
                     ("kimi-k2-1t-a32b", None, "adamw"))
MOE_RANKS_FP32_TOL = 1e-4
#: mla-ranks (b)'s sizes (``rank_sizes``)
MLA_WIDE_SIZES = dict(mesh=(1, 16), prefill=(2, 512), steps=2, max_len=32,
                      train_steps=1, train_seq=512)


def rank_sizes(**over) -> dict:
    """A kind-rank spawn's sizes (``kind_rank_jobs``): the (data, model)
    mesh, the prefill (B, S), the greedy session's decode steps and cache
    slots (the prompt's and the steps' unless given), the training steps
    and sequence; the recurrent-ranks phase's, read when called, with
    ``over``'s changes."""
    sizes = dict(dict(mesh=RECURRENT_RANKS_MESH,
                      prefill=RECURRENT_RANKS_PREFILL,
                      steps=RECURRENT_RANKS_STEPS,
                      train_steps=RECURRENT_RANKS_TRAIN_STEPS,
                      train_seq=TRAIN_SEQ), **over)
    sizes.setdefault("max_len", RECURRENT_RANKS_PROMPT + sizes["steps"])
    return sizes


def rank_optimizer(name: str, steps: int = RECURRENT_RANKS_TRAIN_STEPS):
    """The optimizer ``launch.train.train_on_rank`` makes for a phase's
    ``steps`` (its defaults: lr 1e-3, the warm-up a fifth of the
    steps)."""
    from repro_torch.train.optimizer import make_optimizer
    return make_optimizer(name, lr=1e-3, warmup_steps=min(20, steps // 5 + 1),
                          total_steps=steps)


def state_errors(torch, got, want) -> dict:
    """Two optimizer states (the ranks' replicated one and the one
    card's) leaf by leaf - the largest |code difference| of an int8 leaf,
    max |x - y| / max |y| of a float one - and the worst over the leaves
    of each kind of state leaf, by its first and last path keys ("m/q",
    "v/s", "f/vr", ...): {"leaves": ..., "worst": ...}."""
    from repro_torch.tree import leaves_with_path, path_str
    out = {}
    for (k, x), (_, y) in zip(leaves_with_path(got), leaves_with_path(want)):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            continue
        if x.dtype == torch.int8:        # a whole table's codes: in pieces
            xf, yf, n = x.reshape(-1), y.reshape(-1), 1 << 26
            out[path_str(k)] = max(
                int((xf[i:i + n].short() - yf[i:i + n].short()).abs().max())
                for i in range(0, xf.numel(), n))
        else:
            d = (x.float() - y.float()).abs().max()
            out[path_str(k)] = float(d / y.float().abs().max().clamp(
                min=1e-30))
    worst = {}
    for k, v in out.items():
        kind = f"{k.split('/')[0]}/{k.split('/')[-1]}"
        worst[kind] = max(worst.get(kind, 0), v)
    return {"leaves": out, "worst": worst}


def _recurrent_serve(torch, comms, cfg, local, toks, ops, sent, steps,
                     max_len):
    """Part of a recurrent-ranks (mla-ranks, moe-ranks (b)) rank body: the
    protected greedy session of ``RankModel(cfg, local)`` (the fp32 twin)
    into a cache of ``max_len`` slots: the prompt's token-by-token
    prefill, ``protect_cache`` (RS(1,1) over "data"), ``steps`` greedy
    decode steps, the refresh and the rebuild of data position 0 (each
    EC call timed, ``_rank_timed``), the faulted control, each
    ``decode_step``'s bytes by kind."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.ecstore import ECConfig
    from repro_torch.models.ranked import RankModel
    from repro_torch.serve.engine import ServeEngine
    model = RankModel(cfg, local, comms)
    step = model.decode_step

    def noted(*args):
        sent.append({})
        with recording(lambda n, kind: sent[-1].__setitem__(
                kind, sent[-1].get(kind, 0) + n)):
            return step(*args)
    model.decode_step = noted
    B, P = toks.shape[0], RECURRENT_RANKS_PROMPT
    eng = ServeEngine(model, max_len=max_len, batch_size=B,
                      cache_dtype=torch.float32, device=toks.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = model.argmax(eng.prefill({"tokens": toks[:, :P]}))
    mesh = comms.mesh
    specs = shd.cache_specs(cfg, eng.cache_shapes(), mesh)
    _rank_timed(torch, ops, "create", eng.protect_cache, mesh, specs,
                ECConfig(**RECURRENT_RANKS_EC))
    old = eng.cache_snapshot()
    t1 = time.perf_counter()
    res = eng.decode(steps, first_tokens=first)
    torch.cuda.synchronize()
    out = {"decode_s_per_step": (time.perf_counter() - t1) / steps}
    _rank_timed(torch, ops, "refresh", eng.refresh_cache_parity, old)
    rebuilt = _rank_timed(torch, ops, "rebuild0", eng.recover_cache_pages, 0)
    out["serve_s"] = time.perf_counter() - t0
    live = eng.ec_store.local_pages(eng.cache_tree())
    out["stale"] = _differ(torch, eng.ec_parity,
                           eng.ec_store.encode(eng.cache_tree()))
    faulted = eng.ec_parity.clone()
    faulted.view(-1)[0] ^= 1
    out["faulted_differs"] = _differ(torch, eng.ec_store.reconstruct(
        eng.cache_tree(), faulted, 0), rebuilt)
    out.update(tokens=np_tokens(torch.cat([first[:, None].cpu(), torch.as_tensor(
        res.tokens)], dim=1).tolist()), pages=live.cpu().numpy(),
        rebuilt=rebuilt.cpu().numpy(), cache=_bytes_of(torch, eng.cache_tree()),
        ec_paths=dict(comms.data.op_paths))
    return out


def recurrent_rank_body(comm, jobs):
    """Recurrent-ranks (mla-ranks, moe-ranks (b)) phase, one rank: for
    each job (name, cfg, bf16 blocks, fp32 twin blocks, tokens, ``want``)
    of ``RECURRENT_RANKS`` (``MLA_RANKS``, ``MLA_WIDE``,
    ``MOE_RANKS_REDUCED``: fp32 blocks, their own twin), at the sizes
    ``want["sizes"]`` (``rank_sizes``), with the launch counts from 0:
    the ``apply``
    on the whole batch (its logits block against the one card's,
    ``want["prefill"]``, its bytes by kind, an MoE layer's routes, keep
    flags and drops of the rank's rows); the fp32 twin's protected greedy
    session (``_recurrent_serve``); ``launch.train.train_on_rank`` with the
    job's optimizer on the rank's own copies of its bf16 blocks for the
    sizes' training steps, per step the loss, the norm,
    the seconds and the bytes by kind, and after step 1 a replicated
    optimizer state against the one-card state after its step 1
    (``want["state"]``, None for AdamW's blocks; ``state_errors``); the
    dry run's counts of the
    same prefill, decode step and train step at the rank's coordinates;
    the launches, ``op_paths`` and the training's peak."""
    import torch
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.ranks import rank_comms
    from repro_torch.kernels import (dispatch, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import train_on_rank
    from repro_torch.models import layers, moe
    from repro_torch.models.ranked import RankModel
    from repro_torch.tree import Stacked, tree_map
    torch.cuda.set_device(0)
    comms = rank_comms(comm)
    layers.set_activation_mesh(comms)
    out = {"coords": comm.coords}
    for name, cfg, local, local32, toks, want in jobs:
        sent = {"prefill": {}, "decode": [], "train": {}}
        got = {}
        layers.reset_op_paths()
        reset_launch_counts()
        moe.reset_drops()
        model = RankModel(cfg, local, comms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe.record_routes() as routes, recording(
                lambda n, kind: sent["prefill"].__setitem__(
                    kind, sent["prefill"].get(kind, 0) + n)):
            logits = model.apply({"tokens": toks})
        torch.cuda.synchronize()
        got["prefill_s"] = time.perf_counter() - t0
        got["moe"] = dict(routes=[r.numpy() for r in routes],
                          kept=[k.numpy() for k in routes.kept],
                          drops=moe.dropped_assignments())
        got["prefill_err"] = float((logits.float() - want["prefill"]
                                    .float()).abs().max())
        got["prefill_launches"] = launch_counts()
        got["prefill_routes"] = dict(layers.OP_PATHS)
        got["op_paths"] = dict(model.op_paths)
        del logits, model
        ops = {}
        cfg32 = cfg.scaled(dtype="float32")
        sizes = want["sizes"]
        P = sizes["max_len"]
        got.update(_recurrent_serve(torch, comms, cfg32, local32, toks, ops,
                                    sent["decode"], sizes["steps"], P))
        got["ops"] = ops
        # training on the rank's own copies of its bf16 blocks
        own = tree_map(lambda x: Stacked(p.clone() for p in x.parts)
                       if isinstance(x, Stacked) else x.clone(), local)
        steps, total = [], {}

        def observe(step, st):
            torch.cuda.synchronize()
            steps.append(dict(loss=float(st["metrics"]["loss"]),
                              grad_norm=float(st["metrics"]["grad_norm"]),
                              s=time.perf_counter() - steps_t[0],
                              sent=dict(total)))
            if step == 0 and want["state"] is not None:
                got["state_err"] = state_errors(
                    torch, st["opt_state"], want["state"])
            steps_t[0] = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps_t = [time.perf_counter()]
        with recording(lambda n, kind: total.__setitem__(
                kind, total.get(kind, 0) + n)):
            train_on_rank(comms, cfg, own, steps=sizes["train_steps"],
                          batch=TRAIN_BATCH, seq=sizes["train_seq"],
                          optimizer=rank_optimizer(want["optimizer"],
                                                   sizes["train_steps"]),
                          observe=observe, log=lambda *a: None)
        torch.cuda.synchronize()
        del own
        got["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        got["steps"] = [dict(s, sent={k: v - (steps[i - 1]["sent"].get(k, 0)
                                              if i else 0)
                                      for k, v in s["sent"].items()})
                        for i, s in enumerate(steps)]
        got["launches"] = launch_counts()
        got["train_op_paths"] = dict(layers.OP_PATHS)
        B, S = toks.shape
        mesh, at = comm.mesh, comm.coords
        counts = {   # at 1 and 2 repeats of the unit, extrapolated (exact)
            "prefill": (cfg, lambda c: dryrun.count_rank_forward(
                c, dryrun.ShapeSpec("x", "prefill", S, B), mesh, at)),
            "decode": (cfg32, lambda c: dryrun.count_rank_forward(
                c, dryrun.ShapeSpec("x", "decode", P, B), mesh, at)),
            "train": (cfg, lambda c: dryrun.count_rank_train(
                c, dryrun.ShapeSpec("x", "train", sizes["train_seq"],
                                    TRAIN_BATCH),
                mesh, at, optimizer=want["optimizer"]))}
        with dispatch.dry_run():
            got["counted"] = {
                k: {kind: n for kind, n in dryrun.count_model_cell(
                    c, None, mesh, count=fn)["collectives"].items() if n}
                for k, (c, fn) in counts.items()}
        got["sent"] = sent
        out[name] = got
        torch.cuda.empty_cache()
    layers.set_activation_mesh(None)
    return out


def _recurrent_reference(torch, dev, arch, layers_cut, opt_name, card,
                         label, reduced, sizes):
    """One job's one-card side (``label``: its phase): the model at full
    width (its depth cut to ``layers_cut``), its bf16 prefill logits (an
    MoE layer's routes and keep flags recorded) and their bound
    (``MODEL_RANKS_TWIN_MULTIPLE`` times their distance from the fp32
    twin's); the fp32 twin's greedy session's tokens; one bf16
    step of ``opt_name`` on a copy of the weights (loss, norm, the state
    after it) and the same step of an fp32 twin, from which the norm's bound
    and each kind of state leaf's come (``TWIN_MULTIPLE`` times the gap,
    the worst over the kind's leaves; for adamw8bit's int8 codes at
    least 1: two bf16 steps that round their sums in another order move
    codes by more than one, 5 at the reduced config on the CPU; none
    for AdamW, whose moments a rank holds by block).  ``reduced``: the
    arch's reduced config in fp32, its own twin, AdamW: the logits within
    ``MOE_RANKS_FP32_TOL``, the loss and norm within ``MOE_TRAIN_TOL``;
    ``sizes``: the prefill, the greedy session's decode steps and cache
    slots, the training steps and sequence (``rank_sizes``)."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import Model, moe
    from repro_torch.models.convert import param_tree
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.train_step import make_train_step
    full = get_config(arch)
    cfg = (get_reduced(arch).scaled(dtype="float32") if reduced else
           full.scaled(num_layers=layers_cut or full.num_layers))
    gen = torch.Generator(device=dev)
    gen.manual_seed(RECURRENT_RANKS_SEED)
    model = Model(cfg, device=dev).init(gen)
    B, S = sizes["prefill"]
    steps = sizes["steps"]
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    moe.reset_drops()
    with moe.record_routes() as routes:
        logits = model.apply({"tokens": toks})
    routes = dict(routes=[r.numpy() for r in routes],
                  kept=[k.numpy() for k in routes.kept],
                  drops=moe.dropped_assignments())
    if reduced:
        twin, bound = model, MOE_RANKS_FP32_TOL
    else:
        twin = fp32_twin(torch, model)
        bound = MODEL_RANKS_TWIN_MULTIPLE * logit_err(
            torch, logits, twin.apply({"tokens": toks}))
    _free(torch)
    P = RECURRENT_RANKS_PROMPT
    eng = ServeEngine(twin, max_len=sizes["max_len"], batch_size=B,
                      cache_dtype=torch.float32, device=dev)
    first = twin.argmax(eng.prefill({"tokens": toks[:, :P]}))
    tokens = np_tokens(torch.cat([first[:, None].cpu(), torch.as_tensor(
        eng.decode(steps, first_tokens=first).tokens)],
        dim=1).tolist())
    del eng
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=sizes["train_seq"],
                                   global_batch=TRAIN_BATCH, seed=0),
                        device=dev).batch(0)
    steps = {}
    for dtype in ("float32",) if reduced else ("bfloat16", "float32"):
        trainee = Model(cfg.scaled(dtype=dtype), device=dev)
        trainee.load_state_dict(model.state_dict())
        opt = rank_optimizer(opt_name, sizes["train_steps"])
        params = param_tree(trainee)
        state = opt.init(params)
        _, state, m = make_train_step(trainee, opt)(params, state, batch)
        steps[dtype] = dict(loss=float(m["loss"]),
                            grad_norm=float(m["grad_norm"]), state=state)
        del trainee, params
        _free(torch)
    one, tw = steps[cfg.dtype], steps["float32"]
    replicated = opt_name != "adamw"
    bounds = dict(loss=TRAIN_LOSS_TOL, norm=TWIN_MULTIPLE * abs(
        one["grad_norm"] - tw["grad_norm"]) / tw["grad_norm"], state={
            k: max(1, TWIN_MULTIPLE * v) if k.endswith("/q")
            else TWIN_MULTIPLE * v for k, v in state_errors(
                torch, one["state"], tw["state"])["worst"].items()}
        if replicated else {})
    if reduced:
        bounds.update(loss=MOE_TRAIN_TOL, norm=MOE_TRAIN_TOL)
    tw.pop("state", None)
    if not replicated:
        one["state"] = None
    log(f"{label} [{card}] {arch} one-card ({cfg.num_layers} of "
        f"{full.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}): prefill logit bound {bound}; {opt_name} step 1 "
        f"bf16 loss {one['loss']} norm {one['grad_norm']}, fp32 twin loss "
        f"{tw['loss']} norm {tw['grad_norm']}; bounds {json.dumps(bounds)}")
    return dict(cfg=cfg, model=model, twin=twin, toks=toks, logits=logits,
                bound=bound, tokens=tokens, one=one, bounds=bounds,
                routes=routes)


def run_recurrent_ranks(np, torch, dev, card):
    """The recurrent layer kinds across ranks (module notes, phase 21):
    recurrentgemma-2b ("RRW") and mamba2-370m (``run_kind_ranks``)."""
    return run_kind_ranks(np, torch, dev, card, RECURRENT_RANKS,
                          "recurrent-ranks")


def run_mla_ranks(np, torch, dev, card):
    """MLA across ranks (module notes, phase 22): (a) minicpm3-4b at 2
    layers over (2, 2) (``run_kind_ranks``), its prefill's
    ``_mla_blockwise`` on each rank's stripe, its decode over the
    sequence-sharded latent cache, AdamW on the rank's blocks; (b) the
    same at 1 layer over (1, 16) (``MLA_WIDE_SIZES``): 16 model
    positions, which do not divide its 40 heads, so the head leaves are
    whole on every rank and ``wo`` splits by flat rows."""
    launches, nums = run_kind_ranks(np, torch, dev, card, MLA_RANKS,
                                    "mla-ranks")
    t0 = time.perf_counter()
    more, nums["wide"] = run_kind_ranks(np, torch, dev, card, MLA_WIDE,
                                        "mla-ranks (b)",
                                        rank_sizes(**MLA_WIDE_SIZES))
    log(f"mla-ranks (b) [{card}]: {time.perf_counter() - t0:.1f} s, spawn "
        f"{nums['wide']['spawn_s']:.1f} s")
    return {k: launches[k] + more[k] for k in launches}, nums


def settled_tokens(np, one, got, K: int) -> dict:
    """A rank's rows of one MoE layer against the one card's (``one``,
    ``got``: "routes" (rows, S, K) experts, "kept" their keep flags,
    "probs" (rows, S, E) router probabilities).  A token is settled when
    its top-K experts and their keep flags equal the one card's.  An
    unsettled token is explained when its own route flipped at a near tie
    (the one card's gap between its K-th and (K+1)-th probability at
    most twice the largest |p - p_one| of the token) or, its route
    unflipped, it holds in its row an expert that a flipped assignment
    entered in either run (the capacity's order then moves).  Returns
    the masks and counts."""
    def by_expert(x):
        order = np.argsort(x["routes"], axis=-1)
        return (np.take_along_axis(x["routes"], order, -1),
                np.take_along_axis(x["kept"], order, -1))
    e1, k1 = by_expert(one)
    e2, k2 = by_expert(got)
    same = (e1 == e2).all(-1)
    settled = same & (k1 == k2).all(-1)
    dp = np.abs(got["probs"] - one["probs"]).max(-1)
    top = -np.sort(-one["probs"], axis=-1)
    near_tie = top[..., K - 1] - top[..., K] <= 2 * dp
    explained = settled | (~same & near_tie)
    for b in range(e1.shape[0]):
        touched = set()
        for t in np.flatnonzero(~same[b]):
            touched |= set(e1[b, t].tolist()) ^ set(e2[b, t].tolist())
        for t in np.flatnonzero(same[b] & ~settled[b]):
            explained[b, t] = bool(touched & set(e1[b, t].tolist()))
    return dict(settled=settled, explained=explained,
                n_settled=int(settled.sum()), n=int(settled.size),
                flipped=int((~same).sum()),
                unexplained=int((~explained).sum()))


def moe_rank_body(comm, cfg, local, toks, want, kind_jobs):
    """Moe-ranks phase (a), one rank: with the launch counts from 0, the
    bf16 ``RankModel.apply`` of the whole batch on the rank's blocks
    (shared with the parent), its routes, keep flags, router
    probabilities and drops, each token's largest |logit - the one
    card's| (``want["prefill"]``: its logits block), its bytes by kind
    and seconds; then one protected decode step through ``ServeEngine``
    (a bf16 cache of ``MOE_RANKS_MAX_LEN`` slots protected by RS(1,1)
    over "data" while empty, the one-token prompt's step, the same
    numbers against ``want["decode"]``, the greedy token, the parity
    refreshed, data position 0 rebuilt, a flipped parity byte); the dry
    run's counts of the same prefill and decode step; the launches,
    ``op_paths`` and the peak.  Then part (b): ``recurrent_rank_body`` on
    ``kind_jobs``, under "reduced"."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.ecstore import ECConfig
    from repro_torch.distributed.ranks import rank_comms
    from repro_torch.kernels import (dispatch, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch import dryrun
    from repro_torch.models import layers, moe
    from repro_torch.models.ranked import RankModel
    from repro_torch.serve.engine import ServeEngine
    torch.cuda.set_device(0)
    comms = rank_comms(comm)
    layers.set_activation_mesh(comms)
    sent = {"prefill": {}, "decode": {}}
    layers.reset_op_paths()
    reset_launch_counts()
    moe.reset_drops()
    torch.cuda.reset_peak_memory_stats()
    model = RankModel(cfg, local, comms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe.record_routes() as routes, recording(
            lambda n, kind: sent["prefill"].__setitem__(
                kind, sent["prefill"].get(kind, 0) + n)):
        logits = model.apply({"tokens": toks})
    torch.cuda.synchronize()
    got = {"coords": comm.coords, "prefill_s": time.perf_counter() - t0,
           "prefill_launches": launch_counts(),
           "finite": bool(torch.isfinite(logits).all()),
           "tok_err": (logits.float() - want["prefill"].float()).abs()
           .amax(-1).cpu().numpy(),
           "routes": routes[0].numpy(), "kept": routes.kept[0].numpy(),
           "probs": routes.probs[0].numpy(),
           "drops": moe.dropped_assignments(),
           "op_paths": dict(model.op_paths),
           "prefill_routes": dict(layers.OP_PATHS)}
    del logits
    # one protected decode step: the cache protected while empty, the
    # one-token prompt's step, the parity refreshed, position 0 rebuilt
    ops = {}
    B, S = toks.shape
    eng = ServeEngine(model, max_len=MOE_RANKS_MAX_LEN, batch_size=B,
                      device=toks.device)
    mesh = comm.mesh
    specs = shd.cache_specs(cfg, eng.cache_shapes(), mesh)
    _rank_timed(torch, ops, "create", eng.protect_cache, mesh, specs,
                ECConfig(**RECURRENT_RANKS_EC))
    old = eng.cache_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe.record_routes() as routes, recording(
            lambda n, kind: sent["decode"].__setitem__(
                kind, sent["decode"].get(kind, 0) + n)):
        logits = eng.prefill({"tokens": toks[:, :1]})
    torch.cuda.synchronize()
    got.update(decode_s=time.perf_counter() - t0,
               dec_finite=bool(torch.isfinite(logits).all()),
               dec_err=(logits.float() - want["decode"].float()).abs()
               .amax(-1).cpu().numpy(),
               dec_routes=routes[0][:, 0].numpy(),
               dec_kept=routes.kept[0][:, 0].numpy(),
               dec_probs=routes.probs[0][:, 0].numpy(),
               token=model.argmax(logits).cpu().numpy())
    _rank_timed(torch, ops, "refresh", eng.refresh_cache_parity, old)
    rebuilt = _rank_timed(torch, ops, "rebuild0", eng.recover_cache_pages, 0)
    faulted = eng.ec_parity.clone()
    faulted.view(-1)[0] ^= 1
    got.update(
        stale=_differ(torch, eng.ec_parity,
                      eng.ec_store.encode(eng.cache_tree())),
        faulted_differs=_differ(torch, eng.ec_store.reconstruct(
            eng.cache_tree(), faulted, 0), rebuilt),
        pages=eng.ec_store.local_pages(eng.cache_tree()).cpu().numpy(),
        rebuilt=rebuilt.cpu().numpy(), ec_paths=dict(comms.data.op_paths),
        ops=ops, launches=launch_counts(),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, sent=sent)
    del eng, model, logits
    with dispatch.dry_run():
        got["counted"] = {k: {kind: n for kind, n in dryrun.count_rank_forward(
            cfg, dryrun.ShapeSpec("x", k, s, B), mesh, comm.coords)[
                "collectives"].items() if n}
            for k, s in (("prefill", S), ("decode", MOE_RANKS_MAX_LEN))}
    layers.set_activation_mesh(None)
    torch.cuda.empty_cache()
    got["reduced"] = recurrent_rank_body(comm, kind_jobs)
    return got


def run_moe_full_width(np, torch, dev, card, kind_jobs):
    """Moe-ranks (a): kimi-k2 at full width and ``MOE_RANKS_LAYERS``
    layer(s), bf16, over (data 2, model 2), the ranks on their blocks of
    the parent's one-card model (shared, not copied), against its prefill
    and its decode step of the prompt's token (their routes, keep flags
    and router probabilities recorded): every unsettled token explained
    (``settled_tokens``), the settled tokens' logits within
    ``BF16_LOGIT_TOL``, the share settled printed; the protected step's
    parity a fresh encode, position 0 rebuilt equal to its live pages, a
    flipped parity byte caught; bytes by kind equal
    to the dry run's count; kernel 11 once in a prefill, kernel 1 in the
    EC calls, the card's paths only.  The same ranks then run ``kind_jobs``
    (by rank: part (b), ``recurrent_rank_body``) after (a).  Returns the
    ranks' launches in (a), summed, the numbers, and (b)'s results by
    rank."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model, moe
    from repro_torch.models.convert import param_tree
    from repro_torch.models.ranked import batch_rows
    from repro_torch.tree import Stacked, tree_map
    t0 = time.perf_counter()
    full = get_config(MOE_RANKS_ARCH)
    cfg = full.scaled(num_layers=MOE_RANKS_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(MOE_RANKS_SEED)
    model = Model(cfg, device=dev).init(gen)
    B, S = MOE_RANKS_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    moe.reset_drops()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with moe.record_routes() as routes:
        logits = model.apply({"tokens": toks})
    torch.cuda.synchronize()
    nums = {"one_card_prefill_s": time.perf_counter() - t1,
            "one_card_drops": moe.dropped_assignments(),
            "cap": moe.capacity(S, cfg)}
    one = {"routes": routes[0].numpy(), "kept": routes.kept[0].numpy(),
           "probs": routes.probs[0].numpy()}
    assert nums["one_card_drops"][0] > 0, nums
    # the one card's decode step of the prompt's token, from an empty cache
    with moe.record_routes() as routes:
        dec, _ = model.decode_step(
            model.init_cache(B, MOE_RANKS_MAX_LEN), toks[:, 0], 0)
    one_dec = {"routes": routes[0][:, 0].numpy(),
               "kept": routes.kept[0][:, 0].numpy(),
               "probs": routes.probs[0][:, 0].numpy()}
    mesh = make_mesh(RECURRENT_RANKS_MESH, ("data", "model"))
    A, M = RECURRENT_RANKS_MESH
    params = tree_map(lambda x: Stacked(p.detach() for p in x.parts)
                      if isinstance(x, Stacked) else x.detach(),
                      param_tree(model))
    specs = shd.param_specs(cfg, params, mesh)
    Vl = cfg.padded_vocab // M
    rank_args = []
    for r in range(mesh.size):
        a, m = mesh.coords(r)
        r0, r1 = batch_rows(B, A, a)
        local = tree_map(lambda leaf, spec: shd.local_block(
            leaf, spec, mesh, (a, m)), params, specs)
        rank_args.append((cfg, local, toks, {
            "prefill": logits[r0:r1, :, m * Vl:(m + 1) * Vl],
            "decode": dec[r0:r1, m * Vl:(m + 1) * Vl]}, kind_jobs[r]))
    t1 = time.perf_counter()
    res = launch_on_card(moe_rank_body, rank_args, MOE_RANKS_DEADLINE)
    nums["spawn_s"] = time.perf_counter() - t1
    del rank_args, params, logits, dec, model
    _free(torch)
    torch.cuda.ipc_collect()
    launches, nums["ranks"] = None, []
    K = cfg.experts_per_token
    live = {tuple(x["coords"]): x["pages"] for x in res}
    for x in res:
        at = tuple(x["coords"])
        r0, r1 = batch_rows(B, A, at[0])
        st = settled_tokens(np, {k: v[r0:r1] for k, v in one.items()}, x, K)
        settled_err = float(x["tok_err"][st["settled"]].max(initial=0.0))
        # the decode step: one token a row, the same analysis
        sd = settled_tokens(
            np, {k: v[r0:r1, None] for k, v in one_dec.items()},
            {k: x[f"dec_{k}"][:, None] for k in one_dec}, K)
        dec_err = float(x["dec_err"][sd["settled"][:, 0]].max(initial=0.0))
        n = x["launches"]
        row = {k: x[k] for k in ("prefill_s", "decode_s", "peak_gb",
                                 "drops", "ops", "stale",
                                 "faulted_differs")}
        row.update(coords=at, settled=f"{st['n_settled']} of {st['n']}",
                   settled_share=st["n_settled"] / st["n"],
                   flipped=st["flipped"], unexplained=st["unexplained"],
                   settled_logit_err=settled_err,
                   worst_logit_err=float(x["tok_err"].max()),
                   decode_settled=f"{sd['n_settled']} of {sd['n']}",
                   decode_unexplained=sd["unexplained"],
                   decode_settled_logit_err=dec_err,
                   token=x["token"].tolist(),
                   sent_prefill=x["sent"]["prefill"],
                   sent_decode_step=x["sent"]["decode"],
                   kernel11=n["flash_attention"],
                   kernel1=n["gf_matmul_batched"],
                   rebuilt_vs_live=_differ(
                       torch, torch.from_numpy(x["rebuilt"]),
                       torch.from_numpy(live[0, at[1]])))
        nums["ranks"].append(row)
        log(f"moe-ranks (a) [{card}] {MOE_RANKS_ARCH} rank at {at}: "
            f"{json.dumps(row)}")
        assert x["finite"] and x["dec_finite"], at
        assert st["unexplained"] == 0 and sd["unexplained"] == 0, (
            at, st["unexplained"], sd["unexplained"])
        assert max(settled_err, dec_err) <= BF16_LOGIT_TOL, (
            at, settled_err, dec_err)
        assert x["drops"][0] == int((~x["kept"]).sum()), at
        assert row["rebuilt_vs_live"] == 0, at
        assert x["stale"] == 0 and x["faulted_differs"] > 0, at
        assert x["sent"]["prefill"] == x["counted"]["prefill"], (
            at, x["sent"]["prefill"], x["counted"]["prefill"])
        assert x["sent"]["decode"] == x["counted"]["decode"], (
            at, x["sent"]["decode"], x["counted"]["decode"])
        assert x["prefill_launches"]["flash_attention"] == \
            cfg.layers.count("M"), x["prefill_launches"]
        assert sum(x["prefill_launches"].values()) == \
            x["prefill_launches"]["flash_attention"], x["prefill_launches"]
        assert n["gf_matmul_batched"] > 0, n
        assert x["op_paths"] == {"flash_attention": "cuda-kernel"}, at
        assert not any(k.startswith("masked") for k in x["prefill_routes"])
        assert set(x["ec_paths"].values()) == {"cuda-kernel"}, at
        launches = n if launches is None else {k: launches[k] + n[k]
                                               for k in launches}
    nums["settled_share"] = sum(r["settled_share"] for r in nums["ranks"]) \
        / len(nums["ranks"])
    nums["s"] = time.perf_counter() - t0
    log(f"moe-ranks (a) [{card}] {MOE_RANKS_ARCH} ({cfg.num_layers} of "
        f"{full.num_layers} layers, cap {nums['cap']}, one card drops "
        f"{nums['one_card_drops']}): settled tokens "
        f"{[r['settled'] for r in nums['ranks']]} (share "
        f"{nums['settled_share']:.4f}); prefill s a rank "
        f"{[round(r['prefill_s'], 3) for r in nums['ranks']]}, decode s a "
        f"step {[round(r['decode_s'], 3) for r in nums['ranks']]}"
        f", peak GB {[round(r['peak_gb'], 2) for r in nums['ranks']]}")
    return launches, nums, [x["reduced"] for x in res]


def run_moe_ranks(np, torch, dev, card):
    """MoE across ranks (module notes, phase 23), one spawn of four
    ranks: (a) kimi-k2 at full width (``run_moe_full_width``); (b) both
    MoE archs at their reduced configs in fp32, ``run_kind_ranks``'
    checks (``kind_rank_jobs``, ``check_kind_ranks``): routes, drop set
    and tokens the one card's exactly, the drop count above zero."""
    t_phase = time.perf_counter()
    label = "moe-ranks (b)"
    refs, kind_jobs = kind_rank_jobs(torch, dev, card, MOE_RANKS_REDUCED,
                                     label, reduced=True,
                                     sizes=rank_sizes(steps=MOE_RANKS_STEPS))
    launches, full, res = run_moe_full_width(np, torch, dev, card, kind_jobs)
    del kind_jobs
    more, reduced = check_kind_ranks(np, torch, dev, card, MOE_RANKS_REDUCED,
                                     label, refs, res,
                                     rank_sizes(steps=MOE_RANKS_STEPS))
    for arch, job in reduced["jobs"].items():
        assert job["one_card_drops"][0] > 0, (arch, job["one_card_drops"])
    nums = {"full_width": full, "reduced": reduced,
            "phase_s": time.perf_counter() - t_phase}
    log(f"phase moe-ranks: {nums['phase_s']:.1f} s")
    return {k: launches[k] + more[k] for k in launches}, nums


def kind_rank_jobs(torch, dev, card, jobs, label, reduced=False,
                   sizes=None):
    """The one-card side of ``run_kind_ranks``' ``jobs`` ((arch, depth
    cut, optimizer)) at ``sizes`` (default ``rank_sizes()``): each arch's
    reference (``_recurrent_reference``) by arch, and each rank's jobs
    for ``recurrent_rank_body``, by rank (its blocks of the one-card
    models, the logits block it must match, the optimizer, the
    sizes)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import param_tree
    from repro_torch.models.ranked import batch_rows
    from repro_torch.tree import Stacked, tree_map
    sizes = sizes or rank_sizes()
    refs = {arch: _recurrent_reference(torch, dev, arch, cut, opt, card,
                                       label, reduced, sizes)
            for arch, cut, opt in jobs}
    mesh = make_mesh(sizes["mesh"], ("data", "model"))
    A, M = sizes["mesh"]
    B = sizes["prefill"][0]

    def blocks(m, coords):
        params = tree_map(lambda x: Stacked(p.detach() for p in x.parts)
                          if isinstance(x, Stacked) else x.detach(),
                          param_tree(m))
        specs = shd.param_specs(m.cfg, params, mesh)
        return tree_map(lambda leaf, spec: shd.local_block(
            leaf, spec, mesh, coords), params, specs)
    by_rank = []
    for r in range(mesh.size):
        a, m = mesh.coords(r)
        r0, r1 = batch_rows(B, A, a)
        rank_jobs = []
        for arch, _, opt in jobs:
            ref = refs[arch]
            Vl = ref["cfg"].padded_vocab // M
            rank_jobs.append((
                arch, ref["cfg"], blocks(ref["model"], (a, m)),
                blocks(ref["twin"], (a, m)), ref["toks"], {
                    "prefill": ref["logits"][r0:r1, :, m * Vl:(m + 1) * Vl],
                    "state": ref["one"]["state"], "optimizer": opt,
                    "sizes": sizes}))
        by_rank.append(rank_jobs)
    return refs, by_rank


def launch_on_card(fn, rank_args, deadline, mesh_shape=RECURRENT_RANKS_MESH):
    """``ranks.launch`` of ``fn`` on gloo ranks over ``mesh_shape`` (data,
    model) of this card (four over (2, 2) unless asked), the ranks'
    allocator on expandable segments."""
    from repro_torch.distributed import ranks as rk
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(mesh_shape, ("data", "model"))
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory(prefix="kind_ranks_") as tmp:
            return rk.launch(fn, mesh, rank_args,
                             init_file=os.path.join(tmp, "init"),
                             timeout=deadline)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def run_kind_ranks(np, torch, dev, card, jobs, label, sizes=None):
    """Layer kinds across ranks: gloo ranks over ``sizes["mesh"]`` (four
    over (data 2, model 2) unless asked), each a ``RankModel`` of every
    arch of ``jobs`` ((arch, depth cut, optimizer)) on its blocks of the
    parent's one-card models (``kind_rank_jobs``), at ``sizes``;
    ``label`` names the phase.  Per job
    (``check_kind_ranks``): each rank's bf16 prefill logits block within
    the twin-based bound; an MoE layer's routes, keep flags and drops of
    the rank's rows exactly the one card's; the protected greedy
    session's tokens equal to the one-card fp32 engine's, its pages
    equal to the stacked one-card store's over the cache gathered from
    the ranks, the parity a fresh encode, the rebuilt position 0 its
    live pages and a flipped parity byte changing the rebuild; step 1's
    loss and norm of the job's optimizer within train-ranks' bounds of
    the one-card step, the replicated state against the one card's
    within twice the one card's bf16 distance from its fp32 twin's, by
    kind of state leaf (adamw8bit's codes, at least within 1, and
    scales; adafactor's factors), the worst over the leaves; every
    prefill's, decode step's and last training step's bytes by kind
    equal to the dry run's count; kernel 11 on every attention layer
    (none on an MLA layer, whose prefill takes ``mla_blockwise:torch``
    once a layer), kernel 1 in the EC calls, the card's paths only.  Returns
    the ranks' launches, summed, and the phase's numbers."""
    t_phase = time.perf_counter()
    sizes = sizes or rank_sizes()
    refs, by_rank = kind_rank_jobs(torch, dev, card, jobs, label,
                                   sizes=sizes)
    t0 = time.perf_counter()
    res = launch_on_card(recurrent_rank_body, [(j,) for j in by_rank],
                         RECURRENT_RANKS_DEADLINE, sizes["mesh"])
    spawn_s = time.perf_counter() - t0
    del by_rank
    launches, nums = check_kind_ranks(np, torch, dev, card, jobs, label,
                                      refs, res, sizes)
    nums.update(spawn_s=spawn_s, phase_s=time.perf_counter() - t_phase)
    log(f"phase {label}: {nums['phase_s']:.1f} s")
    return launches, nums


def check_kind_ranks(np, torch, dev, card, jobs, label, refs, res, sizes):
    """``run_kind_ranks``' checks of the ranks' results ``res`` against the
    one-card references ``refs`` (``kind_rank_jobs``) at ``sizes``;
    consumes both.  Returns the ranks' launches, summed, and the numbers
    by job."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.ranked import batch_rows
    mesh = make_mesh(sizes["mesh"], ("data", "model"))
    A = sizes["mesh"][0]
    B = sizes["prefill"][0]
    train_steps = sizes["train_steps"]
    nums = {"jobs": {}}
    launches = None
    for arch, _, opt in jobs:
        ref = refs.pop(arch)
        cfg, bounds = ref["cfg"], ref["bounds"]
        attention = sum(cfg.layers.count(k) for k in "AWM")
        mla = cfg.layers.count("L")
        P = sizes["max_len"]
        stacked, _ = stacked_store(
            torch, dev, cfg.scaled(dtype="float32"),
            [x[arch]["cache"] for x in res],
            [tuple(x["coords"]) for x in res], B, P, torch.float32, mesh,
            RECURRENT_RANKS_EC)
        job = {"one_card": {k: ref["one"][k] for k in ("loss", "grad_norm")},
               "bounds": bounds, "bound_prefill": ref["bound"],
               "one_card_tokens": ref["tokens"],
               "one_card_drops": ref["routes"]["drops"], "ranks": []}
        for x in res:
            got, at = x[arch], tuple(x["coords"])
            s1 = got["steps"][0]
            got.update(
                step1_loss_err=abs(s1["loss"] - ref["one"]["loss"]),
                step1_grad_norm_rel_err=abs(
                    s1["grad_norm"] - ref["one"]["grad_norm"])
                / ref["one"]["grad_norm"],
                pages_diff=_differ(torch, torch.from_numpy(got["pages"])
                                   .to(dev), stacked[at]),
                rebuilt_vs_live=_differ(torch, torch.from_numpy(
                    got["rebuilt"]).to(dev), stacked[0, at[1]]))
            shown = {k: got[k] for k in got if k not in (
                "pages", "rebuilt", "cache", "state_err", "moe")}
            shown["moe_drops"] = got["moe"]["drops"]
            shown["worst_state_err"] = got.get("state_err", {}).get("worst")
            log(f"{label} [{card}] {arch} rank at {at}: "
                f"{json.dumps(shown)}")
            assert got["prefill_err"] <= ref["bound"], (
                at, got["prefill_err"], ref["bound"])
            assert got["tokens"] == ref["tokens"], (at, got["tokens"],
                                                    ref["tokens"])
            assert got["pages_diff"] == 0 and got["rebuilt_vs_live"] == 0, at
            assert got["stale"] == 0 and got["faulted_differs"] > 0, at
            assert got["step1_loss_err"] <= bounds["loss"], (
                at, got["step1_loss_err"])
            assert got["step1_grad_norm_rel_err"] <= bounds["norm"], (
                at, got["step1_grad_norm_rel_err"], bounds["norm"])
            for k, v in (shown["worst_state_err"] or {}).items():
                assert v <= bounds["state"][k], (at, k, v, bounds["state"][k])
            r0, r1 = batch_rows(B, A, at[0])
            one_moe = ref["routes"]
            assert len(got["moe"]["routes"]) == cfg.layers.count("M"), at
            for i, (e, k) in enumerate(zip(one_moe["routes"],
                                           one_moe["kept"])):
                assert np.array_equal(got["moe"]["routes"][i], e[r0:r1]), (
                    at, i)
                assert np.array_equal(got["moe"]["kept"][i], k[r0:r1]), (
                    at, i)
            assert got["moe"]["drops"][0] == sum(
                int((~k[r0:r1]).sum()) for k in one_moe["kept"]), at
            assert got["sent"]["prefill"] == got["counted"]["prefill"], at
            assert all(s == got["counted"]["decode"]
                       for s in got["sent"]["decode"]), (
                at, got["sent"]["decode"][-1], got["counted"]["decode"])
            assert len(got["steps"]) == train_steps, at
            assert got["steps"][-1]["sent"] == got["counted"]["train"], (
                at, got["steps"][-1]["sent"], got["counted"]["train"])
            n = got["launches"]
            assert got["prefill_launches"]["flash_attention"] == attention
            assert n["flash_attention"] == attention * (1 + 2 * train_steps), n
            assert n["gf_matmul_batched"] > 0, n
            assert not any(k.startswith("masked")
                           for k in got["prefill_routes"])
            assert got["prefill_routes"].get("mla_blockwise:torch", 0) == mla
            if attention:
                assert got["op_paths"] == {"flash_attention": "cuda-kernel"}
            else:
                assert got["op_paths"] == {}, got["op_paths"]
            assert set(got["ec_paths"].values()) == {"cuda-kernel"}
            launches = n if launches is None else {k: launches[k] + n[k]
                                                   for k in launches}
            job["ranks"].append({k: shown[k] for k in (
                "prefill_s", "decode_s_per_step", "serve_s",
                "train_peak_gb", "steps", "prefill_err", "step1_loss_err",
                "step1_grad_norm_rel_err", "worst_state_err", "ops",
                "moe_drops")}
                | {"coords": at, "sent_prefill": got["sent"]["prefill"],
                   "sent_decode_step": got["sent"]["decode"][-1],
                   "kernel11": n["flash_attention"],
                   "kernel1": n["gf_matmul_batched"]})
        nums["jobs"][arch] = job
        log(f"{label} [{card}] {arch}: prefill s a rank "
            f"{[round(r['prefill_s'], 3) for r in job['ranks']]}, decode s a "
            f"step {[round(r['decode_s_per_step'], 3) for r in job['ranks']]}"
            f", train s a step (step {train_steps}) "
            f"{[round(r['steps'][-1]['s'], 3) for r in job['ranks']]}, train "
            f"peak GB {[round(r['train_peak_gb'], 2) for r in job['ranks']]}"
            f", bytes sent by kind (rank at (0, 0): prefill, a decode step, "
            f"train step {train_steps}) {json.dumps([job['ranks'][0]['sent_prefill'], job['ranks'][0]['sent_decode_step'], job['ranks'][0]['steps'][-1]['sent']])}"
            f", kernel-11 / kernel-1 launches a rank "
            f"{[(r['kernel11'], r['kernel1']) for r in job['ranks']]}")
        del ref, stacked
    refs.clear()
    res.clear()
    _free(torch)
    torch.cuda.ipc_collect()
    return launches, nums


def run_dryrun(np, torch, dev, card):
    """The dry run against the card.  ``launch.dryrun.run_cell`` counts
    starcoder2-3b ``train_4k`` cut to the train phase's B 2 x S 2,048
    (remat "full", AdamW) on the 1 x 1 mesh, on ``meta``; the same cell
    (``dryrun.build_cell``) is then built on the card: the bytes asked of
    the allocator (``requested_bytes``, before its rounding into blocks)
    once the parameters, optimizer state and batch exist must equal the
    predicted argument bytes, and a
    ``FlopCounterMode`` count of one real step (kernel 11 by its
    formula) must equal the predicted FLOPs.  The predicted and measured
    peaks and the step's seconds beside ``t_compute`` (a share of 989
    TFLOP/s) are printed, with the EC cells' collective bytes on the
    16 x 16 mesh beside the reference chain docstring's per-link 80·S and
    18·S pages; last, ``python -m repro_torch.launch.dryrun --mesh single
    --arch A,... --shape`` of ``CLI_SHAPES`` over the ten archs (one
    process a group of ``CLI_GROUPS``, side by side), run after every
    timed phase so that its CPU load falls on none, must record each
    cell ``ok`` or ``skipped`` with its reason.
    Returns the phase's launches (the card step) and its numbers."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.kernels import (dispatch, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    cut = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    mesh = make_host_mesh()
    t0 = time.perf_counter()
    pred = dryrun.run_cell(MODEL_ARCH, "train_4k", mesh, optimizer="adamw",
                           **cut)
    cfg = get_config(MODEL_ARCH).scaled(remat="full")
    shape = dryrun.cell_shape("train_4k", **cut)
    with dispatch.dry_run():
        whole = dryrun.count_cell(cfg, shape, mesh, "adamw")
    predict_s = time.perf_counter() - t0
    assert whole["flops"] == pred["flops_total"], (whole, pred)

    def requested(which):
        return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]

    _free(torch)
    base = requested("current")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cell = dryrun.build_cell(cfg, shape, mesh, optimizer="adamw",
                             device=dev, generator=gen)
    torch.cuda.synchronize()
    args_bytes = requested("current") - base
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with FlopCounterMode(display=False) as fc:
        cell.step()
    torch.cuda.synchronize()
    launches = launch_counts()
    flops = int(fc.get_total_flops())
    peak = requested("peak") - base
    peak_allocated = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    _, _, metrics = cell.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    assert launches["flash_attention"] == 2 * cfg.num_layers, launches
    assert bool(torch.isfinite(metrics["loss"])), metrics
    del cell, metrics
    _free(torch)
    nums = dict(
        predicted_argument_bytes=pred["argument_bytes_one_card"],
        measured_argument_bytes=args_bytes,
        predicted_flops=pred["flops_total"], measured_flops=flops,
        predicted_peak_bytes=whole["peak"],
        predicted_peak_extrapolated=pred["peak_bytes_one_card"],
        measured_peak_bytes=peak, measured_peak_allocated=peak_allocated,
        step_s=step_s,
        t_compute_s=pred["t_compute"], t_memory_s=pred["t_memory"],
        share_of_989=pred["flops_total"] / step_s / BF16_FLOPS_PER_S,
        flops_by_op=pred["flops_by_op"], predict_s=predict_s)
    log(f"dryrun [{card}]: {json.dumps(nums)}")
    assert args_bytes == nums["predicted_argument_bytes"], nums
    assert flops == pred["flops_total"], nums

    ec = {}
    for op in ("update", "update_chain"):
        res = dryrun.run_cell("ecstore", op, "single")
        block = (res["meta"]["bytes_per_device"] // 4096 // 8) * 4096
        ec[op] = dict(bytes=res["collective_bytes_per_device"],
                      pages_of_S=res["collective_bytes_per_device"] / block,
                      reference_per_link_pages_of_S={"update": 80,
                                                     "update_chain": 18}[op])
    log(f"dryrun EC cells, 16 x 16 mesh, RS(10,8), per device: "
        f"{json.dumps(ec)}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out:
        # one single-threaded process a group of archs, side by side:
        # nothing else runs now
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
             "single", "--arch", group, "--shape", ",".join(CLI_SHAPES),
             "--out", out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for group in CLI_GROUPS]
        group_s = {}
        try:
            for group, proc in zip(CLI_GROUPS, procs):
                stdout, stderr = proc.communicate(timeout=300)
                assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
                took = re.search(r"records in ([0-9.]+) s", stdout)
                group_s[group] = float(took.group(1)) if took else None
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        records = [json.loads(Path(out, f).read_text())
                   for f in sorted(os.listdir(out))]
    assert len(records) == len(ARCH_NAMES) * len(CLI_SHAPES), len(records)
    status = {}
    for r in records:
        assert r["status"] in ("ok", "skipped"), r
        assert r["status"] == "ok" or r["reason"], r
        status[r["status"]] = status.get(r["status"], 0) + 1
    nums.update(ec_cells=ec, cli_cells=status, cli_group_s=group_s,
                cli_s=time.perf_counter() - t0,
                phase_s=time.perf_counter() - t_phase)
    log(f"dryrun CLI --mesh single, {', '.join(CLI_SHAPES)}: "
        f"{json.dumps(status)} in {nums['cli_s']:.1f} s (s a group: "
        f"{json.dumps(group_s)})")
    log(f"phase dryrun: {nums['phase_s']:.1f} s")
    return launches, nums


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import numpy as np
    from repro_torch.configs.memec import CONFIG
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    # full fp32 in every float32 product the script compares
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()                    # nvcc at first use, then ctypes
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)} of {', '.join(_build.SOURCES)})")
    for name, c in sass_check(_build.build(), _build._nvcc()).items():
        log(f"sass {name}: {c['HGMMA']} HGMMA, {c['UTMALDG']} UTMALDG")

    rows = run_kernels(np, torch, dev)
    log(f"kernel 11 faulted control at hd 112 / 256 (ratio to the "
        f"tolerance, must exceed 1): {json.dumps(flash_controls(torch, dev))}")
    log(f"phase kernels: {time.perf_counter() - t_start:.1f} s since start")
    log(f"engine host ms per call, B {BATCH}, C 4096 (turns numpy, cuda, "
        f"cuda, numpy):", json.dumps(engine_calls(np, torch)))
    with ShapeLog(np) as shapes:
        t0 = time.perf_counter()
        launches, rs_cl = run_cluster(np, torch, CONFIG, RS_KERNELS)
        by_phase = {"rs_cluster": launches}
        probe_row = next(r for r in rows if r["name"] == "gf_cuckoo_probe")
        check_probe_on_index(np, torch, rs_cl, probe_row)
        del rs_cl
        log(f"phase RS cluster: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_phase["rdp_cluster"], _ = run_cluster(
            np, torch, dataclasses.replace(CONFIG, scheme="rdp"), RDP_KERNELS)
        log(f"phase RDP cluster: {time.perf_counter() - t0:.1f} s")
        by_phase["rs_14_10_decode"] = run_wide_decode(np, torch)
        by_phase["ops"] = run_ops(np, torch)
        t0 = time.perf_counter()
        by_phase["sharded"] = run_sharded(np, torch, dataclasses.replace(
            CONFIG, shards=4, placement="ring", batch_size=BATCH))
        log(f"phase sharded: {time.perf_counter() - t0:.1f} s")
    shapes.check_launches(by_phase)
    t0 = time.perf_counter()
    losses = main_path_losses(np, torch, dev, shapes)
    log(f"main-path shapes timed: {time.perf_counter() - t0:.1f} s")
    (by_phase["model_prefill"], by_phase["model_decode"],
     by_phase["serve_protect"], model) = run_model(np, torch, dev, card)
    log("model phase:", json.dumps(model))
    gc.collect()
    torch.cuda.empty_cache()
    (by_phase["hybrid_prefill"], by_phase["hybrid_windowed"],
     by_phase["hybrid_decode"], by_phase["hybrid_serve_protect"],
     hybrid) = run_hybrid(np, torch, dev, card)
    log(f"hybrid phase [{card}]:", json.dumps(hybrid))
    (by_phase["families_prefill"], by_phase["families_decode"],
     families) = run_families(np, torch, dev, card)
    log(f"families phase [{card}]:", json.dumps(families))
    by_phase["train"], train = run_train(np, torch, dev, card, rows)
    log(f"train phase [{card}]:", json.dumps(train))
    by_phase["train_hybrid"], train_hybrid = run_train_hybrid(np, torch, dev,
                                                              card)
    log(f"train-hybrid phase [{card}]:", json.dumps(train_hybrid))
    by_phase["train_families"], train_families = run_train_families(
        np, torch, dev, card)
    log(f"train-families phase [{card}]:", json.dumps(train_families))
    by_phase["train_moe"], train_moe = run_train_moe(np, torch, dev, card)
    log(f"train-moe phase [{card}]:", json.dumps(train_moe))
    by_phase["tune"], tuned = run_tune(np, torch, dev, card)
    log(f"tune phase [{card}]:", json.dumps(tuned))
    by_phase["ranks"], ranks = run_ranks(np, torch, dev, card)
    log(f"ranks phase [{card}]:", json.dumps(ranks))
    by_phase["model_ranks"], model_ranks = run_model_ranks(np, torch, dev,
                                                           card)
    log(f"model-ranks phase [{card}]:", json.dumps(model_ranks))
    by_phase["serve_ranks"], serve_ranks = run_serve_ranks(np, torch, dev,
                                                           card)
    log(f"serve-ranks phase [{card}]:", json.dumps(serve_ranks))
    by_phase["train_ranks"], train_ranks = run_train_ranks(np, torch, dev,
                                                           card)
    log(f"train-ranks phase [{card}]:", json.dumps(train_ranks))
    by_phase["recurrent_ranks"], recurrent_ranks = run_recurrent_ranks(
        np, torch, dev, card)
    log(f"recurrent-ranks phase [{card}]:", json.dumps(recurrent_ranks))
    by_phase["mla_ranks"], mla_ranks = run_mla_ranks(np, torch, dev, card)
    log(f"mla-ranks phase [{card}]:", json.dumps(mla_ranks))
    by_phase["moe_ranks"], moe_ranks = run_moe_ranks(np, torch, dev, card)
    log(f"moe-ranks phase [{card}]:", json.dumps(moe_ranks))
    stripe = model_ranks["stripes"]["timed"]
    for row in rows:
        if row["name"] == "flash_attention":
            row["stripe"] = stripe
    by_phase["dryrun"], dry = run_dryrun(np, torch, dev, card)
    log(f"dryrun phase [{card}]:", json.dumps(dry))
    for row in rows:
        row["launches_by_phase"] = {p: n[row["name"]]
                                    for p, n in by_phase.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        if row["name"] in losses:
            row["main_path"] = losses[row["name"]]
        log(json.dumps({k: row[k] for k in (
            "name", "launches", "launches_by_phase", "ms", "kernel_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "shape")}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
