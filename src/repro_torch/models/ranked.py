"""A model of attention, MLA, RG-LRU, Mamba-2 and MoE layers on one rank
of a (data, model) or (pod, data, model) mesh: its forward, its decode, and
its backward for training.

The reference runs its model over a mesh inside one compiled program:
``set_activation_mesh(mesh)`` (``src/repro/models/layers.py:36-79``)
constrains activations by logical dim, ``param_specs`` places the
parameters, and GSPMD partitions the program.  The port has no
partitioner.  Each mesh position is a rank of a ``torch.distributed``
group (``distributed/ranks.py``) and runs ``RankModel``, which computes
that position's part of the reference's program and moves blocks through
the rank's two communicators (``ranks.rank_comms``: its data-axis and
model-axis columns; ``layers.set_activation_mesh`` installs them).  What
a rank computes is the reference's; how blocks move is this module's
plan, since GSPMD's choice cannot be read off.  With A data and M model
positions, rank (a, m):

* **parameters at rest** are the rank's ``sharding.local_block`` of each
  leaf by ``param_specs`` (FSDP over "data"; wq ``(d -> data, H·hd ->
  model)``, w_down ``(f -> model, d -> data)``, ...).  A layer's blocks
  are all-gathered over the data column just before the layer and freed
  after it: no rank holds the whole model;
* **batch rows** follow ``shard_act``'s "batch", the axes ("pod",
  "data"): with P pods, rows (p·A + a)·B/(P·A) on; while B < P·A the
  axes shrink to ("data",) (rows a·B/A on, the same on every pod), and
  while B < A every row is on every position (the demotion to
  replicated); a larger batch that its axes do not divide raises
  (``batch_rows``).  An input is token ids, or an embeddings config's
  (B, S, d) embeddings (no table lookup); positions are (B, S), or (3,
  B, S) for M-RoPE, the rows on their second axis (``batch_specs``).
  The residual stream is replicated over "model".  The forward sends
  nothing over "pod": the parameters are replicated over pods (the
  reference's ``sharding.py``: "pods replicate params for fast
  recovery");
* **attention, ``attn_parallel="seq"``** (the default; kinds "A", "W"
  and "M"): the reference's
  ``blockwise_attention`` stripes Q tiles of ``bq = min(attn_block_q,
  max(S // M, 16))`` rows over "model", tile t = l·M + m to stripe m,
  with S padded to a multiple of M·bq.  The rank projects its stripe's
  rows with the whole wq (its blocks gathered over the model column too),
  runs kernel 11 once on the stripe (``flash_attention(stripe=(bq, M,
  m))``, zero rows for the padding, as the reference pads q) against all
  keys, multiplies its rows by the whole wo and all-gathers the stripes
  back into the residual stream.  K and V are computed on every model
  position (replicated over "model", as in the reference).  With an
  attention softcap the stripe takes the masked route
  (``layers._masked_blockwise`` on the stripe's positions).  A "W"
  layer longer than its window: the reference folds the windows into
  the batch and stripes each window's W rows the same way, so the rank
  projects its stripe's rows of every window and runs the masked route
  on them (``layers.local_attention_stripe``); within one window a "W"
  layer is an "A" layer, as on one device;
* **attention, "head"** (or "auto" with H % M == 0): the rank computes
  its H/M query heads (its wq columns) against the KV heads they read
  (a "W" layer through ``layers.local_attention``), and its wo rows; an
  all-reduce over the model column sums the partial outputs, in the
  activation dtype;
* **MLA** (kind "L", whatever ``attn_parallel`` says: the reference's
  ``_mla_blockwise`` never reads it): in a prefill the reference stripes
  the Q tiles over "model" as ``blockwise_attention`` does.  The rank
  computes the latent (``w_dkv``, ``kv_norm``) and the RoPE key of every
  row, replicated over "model" as K and V are; it projects only its
  stripe's rows through ``w_dq`` -> ``q_norm`` -> ``w_uq`` (or ``wq``),
  gathered whole over the model column, runs
  ``layers._mla_blockwise(stripe=(bq, M, m))`` against every key (each
  KV tile up-projected through the whole ``w_uk`` and ``w_uv``: products
  every model position repeats), multiplies its rows by the whole wo and
  all-gathers the stripes back.  In a decode step slots carry the
  scores: over its slice of the latent cache the rank computes every
  head's fp32 partial max, sum and weighted latent, combined by
  log-sum-exp as below.  Where "model" divides the heads, heads carry
  the projections: the rank computes its H/M heads' queries through its
  ``w_uq`` block (``w_dq`` repeated) and absorbs q_nope through its
  ``w_uk`` block, the absorbed queries and q_rope are all-gathered over
  the model column, and its heads' ``w_uv`` and wo rows follow, then an
  all-reduce.  Where it does not (minicpm3-4b's 40 heads on 16
  positions), ``param_specs`` leaves ``w_uq`` (or ``wq``), ``w_uk`` and
  ``w_uv`` whole on every model position (``fit_spec`` demotes the axis
  that does not divide) and splits ``wo`` by flat rows, across head
  boundaries: the rank computes every head's query and absorption
  (products every model position repeats), gathers no query, takes the
  whole context through the whole ``w_uv`` and keeps the columns its
  ``wo`` rows hold, then the all-reduce (none where ``wo`` is whole);
* **MLP**: w_gate and w_up column-parallel, w_down row-parallel, an
  all-reduce after it (activation dtype);
* **MoE** (kind "M": the attention above, then this FFN): the rank owns
  experts [m·E/M, (m+1)·E/M) (E % M must be 0, else a ``ValueError``),
  the reference's ``param_specs`` (``w_gate``/``w_up`` (model, data,
  None), ``w_down`` (model, None, data)).  The residual stream holds
  every token of the rank's rows on every model position, so each
  position routes them itself: the router (data, None), gathered whole
  over the data column, gives the top-K experts, the capacity, the
  sorted slots and keep flags as one device computes them for these
  rows (``moe.plan``; a product every model position repeats), so the
  drop set is the one device's by construction.  The rank runs its
  experts' slots of the dispatch buffer (``moe.experts``), their blocks
  gathered over the data column ``EXPERT_CHUNK_BYTES`` at a time and
  freed before the next chunk, adds their weighted outputs into a
  partial (rows, S, d), and an all-reduce over the model column sums
  the partials in the activation dtype, as the MLP's does.  The
  reference's ``shard_act(h, "batch", "model")`` moves tokens to the
  experts by an all-to-all of (rows, S·K, d); with the tokens already
  on every model position the all-reduce sends 2(M - 1)/M of (rows, S,
  d) instead, K times less at top-K.  A decode step (S 1) has cap 4 and
  drops nothing;
* **RG-LRU** (kind "R"): the rank owns channels [m·d/M, (m+1)·d/M):
  ``w_x`` and ``w_gate``'s columns (FSDP over "data"), the causal
  conv's taps and bias, ``ba``, ``bi``, ``lam``, and the fp32 log-step
  scan (``rglru.linear_scan``) on them.  ``wa`` and ``wi`` are
  ``(None, model)``: the rank's gate columns read the whole conv output
  ``xb``, so ``xb`` is all-gathered over the model column (the gradient
  of each position's channels summed back over the column);
  ``w_out``'s rows of the channels, then an all-reduce.  Decode keeps
  the rank's "h" (B, d/M) and "conv" (B, K - 1, d/M) blocks, which
  ``cache_specs`` places there;
* **Mamba-2** (kind "S"): the rank owns heads [m·H/M, (m+1)·H/M) (H % M
  must be 0, else a ``ValueError``).  ``in_proj``'s columns are packed
  [z | x | B | C | dt], so its column block does not line up with the
  heads: the whole ``in_proj``, ``conv_w`` and ``conv_b`` are gathered
  over the model column too, and the rank computes its heads' z, x and
  dt columns and the whole (shared) B and C (those products every model
  position repeats).  The SSD chunked scan runs on the heads;
  ``out_norm``, an RMSNorm over the whole d_inner, all-reduces the fp32
  sum of squares over the model column (its gradient summed back), its
  scale block the heads' channels; ``out_proj``'s rows of the heads,
  then an all-reduce.  Decode keeps the heads' "ssm" block; the packed
  "conv" state's channel block (``cache_specs``: contiguous over its
  x | B | C channels) does not line up with the heads either, so a step
  gathers it over the model column, computes the token's whole x | B |
  C input (every model position alike) and writes back the rank's own
  block;
* **embed / logits**: vocab over "model": a masked lookup in the rank's
  rows of the table, then an all-reduce; the logits stay the rank's
  vocab block ``(B_rows, S, V/M)``, the reference's ``shard_act(logits,
  "batch", None, "model")``, a logit softcap applied to the block;
* **decode**: the cache is the rank's block by ``cache_specs``
  (``init_cache``; ``cache_shapes`` gives the whole cache's shapes): its
  batch rows and, where a layer's slots split over "model" (max_len, or
  a "W" layer's ring of min(max_len, W) slots, an "L" layer's latent
  and RoPE-key slots), its contiguous slice of them.  The new K/V (for
  the int8 cache quantized, with their scales; an "L" layer's latent and
  RoPE key) are written by the rank whose slice holds the slot
  (``cache_len``, a ring's ``cache_len`` mod W); each rank computes its
  slice's partial softmax sums (max, sum, weighted V) in fp32 - the
  scores tanh-capped before the max, an int8 cache's scales factored
  out of the dots - and the model column combines them by log-sum-exp
  (an all-gather of the partials, summed in model order) over the valid
  slots (a ring's min(cache_len + 1, W));
* **greedy sampling** (``argmax``): each rank's local (max, index), an
  all-gather over the model column (the first maximum wins, as
  ``torch.argmax``), then over the data (and pod) columns for the whole
  batch; **sampling** (``sample``): the whole batch's logits gathered
  over the model, then the data (and pod) columns, and the one-device
  ``Model.sample`` on them on every rank, from a generator seeded alike
  on every rank: every rank draws every row, so the tokens are the
  one-device engine's for the same logits (drawing a rank's rows alone
  would consume another stream of the generator).

**Training** (``forward`` while autograd records): gradients land on the
rank's own blocks, through the collectives' backwards
(``distributed/ranks.py``).  A parameter gather's backward is a
reduce-scatter, so a block's gradient sums every position's use of the
whole leaf; the input of each column-parallel product (the normed
residual before attention, before the MLP or the experts and before the
unembedding) passes through ``ranks.sum_grad``, which sums its gradient
over the model column, as do the wk and wv blocks (replicated over
"model", and every model position's K and V serve only its own query
rows or heads), MLA's ``w_dkv``, ``w_dq`` and norm scales, and the MoE
router (each position's top-K weights reach only its own experts'
outputs); an expert block's gradient stays on its model position (the
chunk gathers' backward reduce-scatters it over the data column);
the row-parallel all-reduces pass their gradient through, and the
"seq" stripes' gather hands each position its rows' gradient.  A
replicated norm scale then has its whole gradient on every model
position of a data column; the train step sums the leaves that "data"
does not split over the data column, and every leaf over the pods
(``train/train_step.py``).  ``cfg.remat`` is honoured as ``Model``
honours it: under "full" each repeat of the layer unit is recomputed in
the backward, its blocks gathered again.

Every result is the one-device model's up to the order of sums.  The
arithmetic a rank shares with ``Model`` is ``layers.py``'s own (RoPE and
M-RoPE, the embedding lookup, the SwiGLU MLP, the unembedding, kernel
11's route, the masked and local attention, int8 quantization, the
unsharded decode attention, MLA's blockwise prefill) and ``rglru.py``'s
and ``mamba2.py``'s (the conv, the gates, the scan, the SSD and its
one-token step) and ``moe.py``'s (the routing plan, the experts'
dispatch, products and combine); what is this module's is the split:
which rows, heads, channels, slices and experts a rank computes and how
blocks move.  ``READ_FIELDS`` names every ``ModelConfig`` field the rank
path reads; a field outside it fails the rank tests, so a new option
cannot go unread here.  On a 1 x 1 mesh
``RankModel`` is today's ``Model`` on the rank's (whole) blocks, and
``params`` are that model's parameters (sharing the blocks' storage).

``repeated`` counts, by product, the matrix-product FLOPs that every
model position computes alike (the plan's repeats: K and V everywhere,
and in a "seq" decode step wq and wo too; MLA's ``w_dkv``, in a prefill
its KV tiles' ``w_uk`` and ``w_uv`` up-projections, in a decode step
``w_dq``; Mamba-2's B and C columns, and in a decode step the token's
whole x | B | C input; MoE's router; with whole MLA heads, a decode
step's ``w_uq`` or ``wq``, ``w_uk`` and ``w_uv`` too, and ``wo`` where it
is whole); the dry run reports them beside a rank's count
(``launch/dryrun.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from types import SimpleNamespace

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..distributed import ranks
from ..distributed import sharding as shd
from ..kernels import dispatch
from ..kernels.flash_attention import stripe_positions
from ..tree import Stacked, tree_map
from . import layers as L
from . import mamba2, moe, rglru
from .config import ModelConfig
from .layers import NEG_INF, rmsnorm
from .transformer import (FFN_KINDS, REMAT_CONTEXTS, Model, stack_cache,
                          unstack_cache)

#: ``ModelConfig`` fields the rank path reads as ``Model``'s layers do
#: (``remat``: honoured while autograd records, as ``Model.forward``
#: honours it; a forward without gradients ignores it alike); a field
#: missing from it fails the rank tests
READ_FIELDS = frozenset({
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "head_dim", "layer_pattern", "rope_kind",
    "rope_theta", "mrope_sections", "local_window", "attn_logit_softcap",
    "attn_block_q", "attn_block_kv", "attn_parallel", "kv_cache_dtype",
    "input_mode", "tie_embeddings", "norm_eps", "logit_softcap", "dtype",
    "remat", "rglru_conv", "rglru_c", "ssm_state", "ssm_expand",
    "ssm_headdim", "ssm_conv", "ssm_chunk", "ssm_groups", "q_lora_rank",
    "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim",
    "num_experts", "experts_per_token", "moe_capacity_factor"})

#: bytes of gathered expert weights a rank holds at once: it gathers its
#: experts' blocks over the data column this many bytes' worth at a time
#: (at least one expert), runs them and frees them before the next chunk
EXPERT_CHUNK_BYTES = 1 << 30


def unclassified_fields() -> set:
    """``ModelConfig`` fields the rank path does not say it reads (none,
    or a new option was added without saying what the rank path does)."""
    return {f.name for f in dataclasses.fields(ModelConfig)} - READ_FIELDS


MESH_AXES = (("data", "model"), ("pod", "data", "model"))

#: an MLA layer's head-split leaves, gathered whole over the model column
#: in a prefill (the stripe reads every head)
MLA_HEADS = ("w_uq", "wq", "w_uk", "w_uv", "wo")


def check_config(cfg: ModelConfig, mesh) -> None:
    """Raise unless ``cfg`` runs across ranks on ``mesh`` (module notes);
    every config runs on a 1 x 1 mesh."""
    if mesh.size == 1:
        return
    if tuple(mesh.axis_names) not in MESH_AXES:
        raise ValueError(f"a model across ranks takes a (data, model) or "
                         f"(pod, data, model) mesh, not {mesh.axis_names}")
    M = mesh.shape["model"]
    sizes = [("d_ff", cfg.d_ff), ("the padded vocab", cfg.padded_vocab)]
    if "R" in cfg.layers:
        sizes.append(("the RG-LRU width d_model", cfg.d_model))
    if "S" in cfg.layers:
        sizes.append(("the Mamba-2 head count", cfg.ssm_heads))
    if "M" in cfg.layers:
        sizes.append(("the expert count", cfg.num_experts))
    for what, n in sizes:
        if n % M:
            raise ValueError(f"{cfg.name}: {what} {n} does not split over "
                             f"{M} model positions")


def head_parallel(cfg: ModelConfig, M: int) -> bool:
    """The reference's ``_head_parallel``: "head", or "auto" with H % M ==
    0, and only when M > 1 divides H."""
    H = cfg.num_heads
    want = (cfg.attn_parallel == "head" or
            (cfg.attn_parallel == "auto" and H % max(M, 1) == 0))
    return want and M > 1 and H % M == 0


def _batch_split(B: int, A: int, pods: int) -> int:
    """How many row blocks ``shard_act``'s "batch" cuts a batch of B into
    on P pods of A data positions: P·A, A (the axes shrunk to ("data",))
    or 1 (replicated).  A batch at or above its axes' size that they do
    not divide raises: the activations would split it unevenly, leaving a
    position no rows, while ``cache_specs`` replicates it."""
    axes = [(pods * A, "(pod, data)")] if pods > 1 else []
    for n, where in axes + [(A, "data")]:
        if B < n:
            continue
        if B % n:
            raise ValueError(f"a batch of {B} on {n} {where} positions: "
                             f"take a batch that the axes divide, or one "
                             f"smaller than them")
        return n
    return 1


def batch_rows(B: int, A: int, index: int, pods: int = 1,
               pod: int = 0) -> tuple[int, int]:
    """The rows [r0, r1) of a batch of B that data index ``index`` of A
    on pod ``pod`` of ``pods`` holds: ``shard_act``'s "batch" (module
    notes; every row when B < A)."""
    n = _batch_split(B, A, pods)
    if n == 1:
        return 0, B
    i = pod * A + index if n > A else index
    per = B // n
    return i * per, (i + 1) * per


def batch_copies(B: int, A: int, pods: int = 1) -> int:
    """How many (pod, data) positions hold each row of a batch of B."""
    return pods * A // _batch_split(B, A, pods)


def seq_stripe(cfg: ModelConfig, S: int, M: int, m: int) -> dict:
    """Stripe m of the reference's striped Q tiles of an S-token prefill:
    ``bq``, the stripe's ``rows`` (``n_local``·bq) and how many of them,
    a prefix, lie below S (``valid``)."""
    bq = min(cfg.attn_block_q, max(S // M, 16))
    nq = -(-S // bq)
    nq = -(-nq // M) * M
    n_local = nq // M
    valid = sum(max(0, min(bq, S - (l * M + m) * bq))
                for l in range(n_local))
    return {"bq": bq, "n_local": n_local, "rows": n_local * bq,
            "valid": valid}


def _split_dim(spec, axis: str):
    """The dimension ``spec`` splits over ``axis``, or None."""
    dims = [i for i, e in enumerate(spec) if axis in shd.entry_axes(e)]
    if not dims:
        return None
    (i,) = dims
    if shd.entry_axes(spec[i]) != (axis,):
        raise ValueError(f"spec {spec}: dimension {i} splits over several "
                         f"axes")
    return i


class RankModel:
    """A config of "A", "W", "L", "R", "S" and "M" layers on this rank
    (module notes).

    ``params``: the rank's blocks of the parameter tree in the
    reference's layout (``convert.param_tree`` cut by
    ``sharding.local_block`` at the rank's coordinates; a training rank's
    own copies, which the optimizer updates in place); ``comms``: the
    rank's ``ranks.AxisComms`` (default: the ones
    ``layers.set_activation_mesh`` installed).  ``apply``, ``forward``
    (the same, recording gradients when autograd does) and
    ``decode_step`` take the whole batch and return the rank's logits
    block; ``argmax`` and ``sample`` turn a decode step's logits block
    into the whole batch's tokens.  ``ServeEngine`` drives it as it
    drives a ``Model``, its cache protected by an ``ECStateStore`` over
    the rank's data column; ``train.train_step.make_rank_train_step``
    trains it."""

    def __init__(self, cfg: ModelConfig, params: dict, comms=None):
        comms = L.activation_mesh() if comms is None else comms
        if comms is None:
            raise ValueError("no rank communicators: pass comms or call "
                             "layers.set_activation_mesh first")
        self.cfg = cfg
        self.comms = comms
        self.mesh = comms.mesh
        self.params = params
        self.A, self.M = comms.data.axis_size, comms.model.axis_size
        self.a, self.m = comms.data.index, comms.model.index
        self.P, self.p = ((1, 0) if comms.pod is None else
                          (comms.pod.axis_size, comms.pod.index))
        self.repeated: collections.Counter = collections.Counter()
        self.op_paths: dict[str, str] = {}
        self._batch = None
        check_config(cfg, self.mesh)
        self.specs = shd.param_specs(cfg, _global_shapes(cfg), self.mesh)
        self._one = _one_device(cfg, params) if self.mesh.size == 1 else None
        if self._one is not None:
            from .convert import param_tree
            self.params = param_tree(self._one)
        else:
            self.head_parallel = head_parallel(cfg, self.M)

    # -- layout ---------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.params["final_norm"]["scale"].device

    @property
    def unit(self) -> str:
        return self.cfg.layer_pattern

    @property
    def repeats(self) -> int:
        return self.cfg.num_layers // len(self.unit)

    def _layer(self, i: int) -> tuple[dict, dict]:
        """Layer i's blocks and specs (a stacked leaf's repeat axis
        dropped)."""
        n, R = len(self.unit), self.repeats
        if i < n * R:
            r, u = divmod(i, n)
            return (tree_map(lambda x: x.parts[r] if isinstance(x, Stacked)
                             else x, self.params["blocks"][u]),
                    tree_map(lambda s: shd.P(*s[1:]),
                             self.specs["blocks"][u]))
        return self.params["tail"][i - n * R], self.specs["tail"][i - n * R]

    def _comm(self, axis: str):
        return self.comms.data if axis == "data" else self.comms.model

    def _gather(self, t: torch.Tensor, spec, axis: str) -> torch.Tensor:
        """``t``'s blocks of the ``axis`` column joined along the dimension
        ``spec`` splits over it (``t`` itself when it splits none)."""
        i = _split_dim(spec, axis)
        if i is None:
            return t
        g = ranks.all_gather(self._comm(axis), t).movedim(0, i)
        return g.reshape(*t.shape[:i], -1, *t.shape[i + 1:])

    def _gathered(self, tree: dict, specs: dict, model_too=()) -> dict:
        """Every leaf of ``tree`` gathered over the data column; the leaves
        named in ``model_too`` over the model column too.  A leaf that
        "model" does not split has its gradient summed over the model
        column (module notes)."""
        out = {}
        for k, t in tree.items():
            if isinstance(t, dict):
                out[k] = self._gathered(t, specs[k], model_too)
                continue
            if _split_dim(specs[k], "model") is None:
                t = ranks.sum_grad(self.comms.model, t)
            t = self._gather(t, specs[k], "data")
            out[k] = self._gather(t, specs[k], "model") if k in model_too \
                else t
        return out

    def _mm(self, name: str, x, w, repeated: bool = False):
        """``x @ w``; a product every model position computes alike adds
        its FLOPs to ``repeated[name]``."""
        if repeated:
            self._repeat(name, 2 * x.numel() * w.shape[-1])
        return x @ w

    def _repeat(self, name: str, flops: int) -> None:
        """Note ``flops`` of a product every model position computes
        alike."""
        if self.M > 1:
            self.repeated[name] += flops

    def rows(self, B: int) -> tuple[int, int]:
        """The rows of a batch of B that this rank holds (``batch_rows``)."""
        return batch_rows(B, self.A, self.a, self.P, self.p)

    def copies(self, B: int) -> int:
        """How many ranks of the model's column hold each of those rows
        (``batch_copies``)."""
        return batch_copies(B, self.A, self.P)

    def _rows(self, B: int) -> tuple[int, int]:
        self._batch = B
        return self.rows(B)

    # -- embeddings -------------------------------------------------------------
    def _table(self, name: str):
        p = self.params["embeddings"]
        return self._gather(p[name], self.specs["embeddings"][name], "data")

    def _embed(self, tokens):
        """``layers.embed`` on the rank's rows of the table (V/M, d),
        zero for the tokens outside them, summed over the model column."""
        table = self._table("embed")
        Vl = table.shape[0]
        ids = tokens - self.m * Vl
        mine = (ids >= 0) & (ids < Vl)
        x = L.embed(SimpleNamespace(embed=table), ids.clamp(0, Vl - 1),
                    self.cfg)
        return ranks.all_reduce(self.comms.model,
                                torch.where(mine[..., None], x, 0.0))

    def _unembed(self, x):
        """``layers.unembed`` on the rank's vocab block of the table: the
        rank's vocab block of the logits, in the activation dtype."""
        name = "embed" if self.cfg.tie_embeddings else "unembed"
        return L.unembed(SimpleNamespace(**{name: self._table(name)}), x,
                         self.cfg)

    # -- attention -------------------------------------------------------------
    def _kv_heads(self, k, v):
        """The KV heads this rank's H/M query heads read, in the layout
        whose GQA grouping maps local head i to the right one."""
        H, KV = self.cfg.num_heads, self.cfg.num_kv_heads
        Hl, G = H // self.M, H // KV
        if Hl % G == 0:
            j = self.m * Hl // G
            return k[:, :, j:j + Hl // G], v[:, :, j:j + Hl // G]
        if G % Hl == 0:
            j = self.m * Hl // G
            return k[:, :, j:j + 1], v[:, :, j:j + 1]
        ids = (self.m * Hl + torch.arange(Hl, device=k.device)) // G
        return k.index_select(2, ids), v.index_select(2, ids)

    def _attention(self, p: dict, h, positions, local: bool, at=None):
        """A layer's attention; ``local`` for kind "W".  ``at`` (decode):
        (cache, write slot, valid slots, the rank's first slot or None for
        an unsharded cache)."""
        cfg = self.cfg
        B, S, _ = h.shape
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        k = L.embed_positions(cfg, self._mm("wk", h, p["wk"], True)
                              .reshape(B, S, KV, hd), positions)
        v = self._mm("wv", h, p["wv"], True).reshape(B, S, KV, hd)
        if at is not None:
            return self._decode_attention(p, h, positions, k, v, *at)
        windowed = local and cfg.local_window and cfg.local_window < S
        if self.head_parallel:
            Hl = H // self.M
            q = L.embed_positions(cfg, self._mm("wq", h, p["wq"])
                                  .reshape(B, S, Hl, hd), positions)
            kh, vh = self._kv_heads(k, v)
            out = (L.local_attention(q, kh, vh, cfg) if windowed
                   else self._attend(q, kh, vh))
            y = self._mm("wo", out.reshape(B, S, Hl * hd), p["wo"])
            return ranks.all_reduce(self.comms.model, y)
        if windowed:
            return self._local_stripes(p, h, positions, k, v)
        st = seq_stripe(cfg, S, self.M, self.m)
        bq, rows, nv = st["bq"], st["rows"], st["valid"]
        idx = stripe_positions(rows, (bq, self.M, self.m), h.device)[:nv]
        q = self._mm("wq", h.index_select(1, idx), p["wq"])
        q = L.embed_positions(cfg, q.reshape(B, nv, H, hd),
                              positions.index_select(-1, idx))
        # the reference's zero padding rows (none on most ranks: every
        # rank pads alike, so that their backward graphs match)
        q = nn.functional.pad(q, (0, 0, 0, 0, 0, rows - nv))
        out = self._attend(q, k, v, (bq, self.M, self.m))
        y = self._mm("wo", out[:, :nv].reshape(B, nv, H * hd), p["wo"])
        y = nn.functional.pad(y, (0, 0, 0, rows - nv))
        g = ranks.all_gather_rows(self.comms.model, y)  # (M, B, rows, d)
        g = g.reshape(self.M, B, st["n_local"], bq, -1).permute(1, 2, 0, 3, 4)
        return g.reshape(B, st["n_local"] * self.M * bq, -1)[:, :S]

    def _local_stripes(self, p, h, positions, k, v):
        """Kind "W" past one window under "seq": the reference folds the
        windows into the batch and stripes each window's Q tiles over
        "model" (``blockwise_attention`` on the (B·nW, W) fold), so the
        rank projects its stripe's rows of every window (zero rows for the
        sequence's padding), runs the masked route on them
        (``layers.local_attention_stripe``) and gathers the stripes back
        as an "A" layer does."""
        cfg = self.cfg
        B, S, _ = h.shape
        H, hd, W = cfg.num_heads, cfg.head_dim, cfg.local_window
        nW = -(-S // W)
        st = seq_stripe(cfg, W, self.M, self.m)
        bq, rows, nv = st["bq"], st["rows"], st["valid"]
        idx = stripe_positions(rows, (bq, self.M, self.m), h.device)[:nv]
        pad = nW * W - S
        hw = nn.functional.pad(h, (0, 0, 0, pad)).unflatten(1, (nW, W))
        pw = nn.functional.pad(positions, (0, pad)).unflatten(-1, (nW, W))
        q = self._mm("wq", hw.index_select(2, idx), p["wq"])
        q = L.embed_positions(cfg, q.reshape(B, nW * nv, H, hd),
                              pw.index_select(-1, idx).flatten(-2))
        q = nn.functional.pad(q.reshape(B, nW, nv, H, hd),
                              (0, 0, 0, 0, 0, rows - nv))
        out = L.local_attention_stripe(q, k, v, cfg, (bq, self.M, self.m))
        y = self._mm("wo", out[:, :, :nv].reshape(B, nW, nv, H * hd),
                     p["wo"])
        y = nn.functional.pad(y, (0, 0, 0, rows - nv))
        g = ranks.all_gather_rows(self.comms.model, y)  # (M, B, nW, rows, d)
        g = g.reshape(self.M, B, nW, st["n_local"], bq, -1) \
            .permute(1, 2, 3, 0, 4, 5).reshape(B, nW, -1, g.shape[-1])
        return g[:, :, :W].reshape(B, nW * W, -1)[:, :S]

    def _attend(self, q, k, v, stripe=None):
        """Causal attention through the layers' route: kernel 11 (its
        plain version on the CPU), recording its dispatch path, or with a
        softcap the masked route."""
        if not self.cfg.attn_logit_softcap:
            self.op_paths["flash_attention"] = dispatch.decide(q).path
        return L.blockwise_attention(q, k, v, self.cfg, causal=True,
                                     stripe=stripe)

    def _decode_attention(self, p, h, positions, k, v, cache, slot: int,
                          n_valid: int, s0):
        cfg = self.cfg
        B = h.shape[0]
        H, hd = cfg.num_heads, cfg.head_dim
        Hl = H // self.M if self.head_parallel else H
        q = self._mm("wq", h, p["wq"], not self.head_parallel)
        q = L.embed_positions(cfg, q.reshape(B, 1, Hl, hd), positions)
        if self.head_parallel:                       # every head's query
            q = self.comms.model.all_gather(q).permute(1, 2, 0, 3, 4) \
                .reshape(B, 1, H, hd)
        S_loc = cache["k"].shape[1]
        start = 0 if s0 is None else s0
        if start <= slot < start + S_loc:            # this rank's slot
            i = slot - start
            if "k_scale" in cache:                   # int8 KV cache
                for name, t in (("k", k), ("v", v)):
                    t8, ts = L.quantize_kv(t)
                    cache[name][:, i] = t8[:, 0]
                    cache[f"{name}_scale"][:, i] = ts[:, 0].to(
                        cache[f"{name}_scale"].dtype)
            else:
                cache["k"][:, i] = k[:, 0].to(cache["k"].dtype)
                cache["v"][:, i] = v[:, 0].to(cache["v"].dtype)
        if s0 is not None:
            out = self._decode_combined(q, cache, s0, n_valid)
        elif "k_scale" in cache:
            out = L.decode_attention_q8(q, cache["k"], cache["k_scale"],
                                        cache["v"], cache["v_scale"],
                                        n_valid, cfg.attn_logit_softcap)
        else:
            out = L.decode_attention(q, cache["k"], cache["v"], n_valid,
                                     cfg.attn_logit_softcap)
        if not self.head_parallel:
            return self._mm("wo", out.reshape(B, 1, H * hd), p["wo"], True)
        mine = out[:, :, self.m * Hl:(self.m + 1) * Hl].reshape(B, 1, Hl * hd)
        return self.comms.model.all_reduce(self._mm("wo", mine, p["wo"]))

    def _decode_combined(self, q, cache: dict, s0: int, n_valid: int):
        """Single-token attention over the model column's cache slices
        (slots s0... on this rank): this slice's partial max, sum and
        weighted V in fp32 - the scores tanh-capped before the max, an
        int8 cache's scales factored out of the dots as
        ``layers.decode_attention_q8`` factors them - all-gathered and
        combined by log-sum-exp in model order."""
        L._count("decode_ranked:torch")
        k_cache, v_cache = cache["k"], cache["v"]
        B, S, KV, hd = k_cache.shape
        H = q.shape[2]
        G = H // KV
        softcap = self.cfg.attn_logit_softcap
        qg = q.reshape(B, KV, G, hd)
        s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                         k_cache.float()) / math.sqrt(hd)
        q8 = "k_scale" in cache
        if q8:
            s = s * cache["k_scale"].permute(0, 2, 1)[:, :, None, :]
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        valid = (s0 + torch.arange(S, device=q.device)) < n_valid
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        mx = s.amax(dim=-1)
        pr = torch.exp(s - mx[..., None])
        pv = pr * cache["v_scale"].permute(0, 2, 1)[:, :, None, :] if q8 \
            else pr
        part = torch.cat([torch.einsum("bkgs,bskh->bkgh", pv, v_cache.float()),
                          mx[..., None], pr.sum(dim=-1)[..., None]], dim=-1)
        g = self.comms.model.all_gather(part)        # (M, B, KV, G, hd + 2)
        o, m_r, l_r = g[..., :hd], g[..., hd], g[..., hd + 1]
        w = torch.exp(m_r - m_r.amax(dim=0))
        out = (o * w[..., None]).sum(dim=0) / (l_r * w).sum(dim=0)[..., None]
        return out.reshape(B, 1, H, hd).to(q.dtype)

    # -- MLA ---------------------------------------------------------------
    def _mla_query(self, p: dict, h, repeated=()):
        """The queries (B, S, heads, nope + rope) of ``h``'s rows through
        the q LoRA (``w_dq`` -> ``q_norm`` -> ``w_uq``) or ``wq``, for the
        heads of the ``w_uq``/``wq`` given (whole, or the rank's block);
        ``repeated`` names the products of these rows that every model
        position computes alike (decode: ``w_dq``, and with whole heads
        ``w_uq`` or ``wq``)."""
        if "w_dq" not in p:
            if "wq" in repeated:
                self._repeat("wq", 2 * h.numel() * p["wq"][0].numel())
            return torch.einsum("bsd,dhe->bshe", h, p["wq"])
        ql = rmsnorm(p["q_norm"]["scale"],
                     self._mm("w_dq", h, p["w_dq"], "w_dq" in repeated))
        if "w_uq" in repeated:
            self._repeat("w_uq", 2 * ql.numel() * p["w_uq"][0].numel())
        return torch.einsum("bsr,rhd->bshd", ql, p["w_uq"])

    def _mla(self, p: dict, specs: dict, h, positions, at=None):
        """Kind "L" (module notes).  Prefill: the latent and RoPE key of
        every row, the stripe's queries through the whole ``w_uq`` (or
        ``wq``), ``layers._mla_blockwise`` on the stripe against every key
        (each KV tile up-projected through the whole ``w_uk``/``w_uv``),
        the stripe's rows through the whole ``wo``, the stripes gathered
        back.  ``at`` (decode): (cache, write slot, valid slots, the
        rank's first slot or None for an unsharded cache); the blocks of
        the heads' projections are the rank's (``specs``)."""
        cfg = self.cfg
        B, S, _ = h.shape
        r, nope = cfg.kv_lora_rank, cfg.qk_nope_dim
        ckv = self._mm("w_dkv", h, p["w_dkv"], True)            # every row
        latent = rmsnorm(p["kv_norm"]["scale"], ckv[..., :r])
        k_rope = L.embed_positions(cfg, ckv[..., r:][:, :, None, :],
                                   positions)
        if at is not None:
            return self._mla_decode(p, specs, h, positions, latent, k_rope,
                                    *at)
        st = seq_stripe(cfg, S, self.M, self.m)
        bq, rows, nv = st["bq"], st["rows"], st["valid"]
        idx = stripe_positions(rows, (bq, self.M, self.m), h.device)[:nv]
        q = self._mla_query(p, h.index_select(1, idx))
        q_rope = L.embed_positions(cfg, q[..., nope:],
                                   positions.index_select(-1, idx))
        # the reference's zero padding rows, as ``_attention`` pads them
        pad = (0, 0, 0, 0, 0, rows - nv)
        q_nope = nn.functional.pad(q[..., :nope], pad)
        q_rope = nn.functional.pad(q_rope, pad)
        w_uk, w_uv = p["w_uk"], p["w_uv"]
        for name, w in (("w_uk", w_uk), ("w_uv", w_uv)):
            self._repeat(name, 2 * latent.numel() * w[0].numel())
        out = L._mla_blockwise(q_nope, q_rope, latent, k_rope,
                               SimpleNamespace(w_uk=w_uk, w_uv=w_uv), cfg,
                               stripe=(bq, self.M, self.m))
        y = self._mm("wo", out[:, :nv].flatten(2), p["wo"])
        y = nn.functional.pad(y, (0, 0, 0, rows - nv))
        g = ranks.all_gather_rows(self.comms.model, y)  # (M, B, rows, d)
        g = g.reshape(self.M, B, st["n_local"], bq, -1).permute(1, 2, 0, 3, 4)
        return g.reshape(B, st["n_local"] * self.M * bq, -1)[:, :S]

    def _mla_decode(self, p, specs, h, positions, latent, k_rope, cache,
                    slot: int, n_valid: int, s0):
        """One token of kind "L" over the rank's latent cache slice (slots
        s0...; the whole cache when s0 is None): slots carry the scores.
        The rank writes the token's latent and RoPE key where its slice
        holds ``slot``.  Where ``w_uk`` splits over "model", heads carry
        the projections: the rank computes its heads' queries, absorbs
        q_nope through its ``w_uk`` block and the model column
        all-gathers them; else (whole heads) the rank computes every
        head's, as every model position does.  Each rank's slice gives
        every head's fp32 partial max, sum and weighted latent,
        all-gathered and combined by log-sum-exp in model order (a slice
        with no valid slot adds exactly nothing); the combined context
        goes through ``w_uv`` (the rank's heads', or every head's) to the
        columns that the rank's ``wo`` rows hold, [c0, c0 + R) of the
        flattened (H·v_head) dimension, then through ``wo`` and an
        all-reduce (none where ``wo`` is whole)."""
        L._count("mla_decode_ranked:torch")
        cfg = self.cfg
        B = h.shape[0]
        nope, H, vd = cfg.qk_nope_dim, cfg.num_heads, cfg.v_head_dim
        whole = _split_dim(specs["w_uk"], "model") is None
        lat_c, kr_c = cache["latent"], cache["k_rope"]
        S_loc = lat_c.shape[1]
        start = 0 if s0 is None else s0
        if start <= slot < start + S_loc:            # this rank's slot
            lat_c[:, slot - start] = latent[:, 0].to(lat_c.dtype)
            kr_c[:, slot - start] = k_rope[:, 0, 0].to(kr_c.dtype)
        q = self._mla_query(p, h, ("w_dq", "w_uq", "wq") if whole
                            else ("w_dq",))    # (B, 1, heads, nope+rope)
        q_rope = L.embed_positions(cfg, q[..., nope:], positions)
        q_abs = torch.einsum("bshd,rhd->bshr", q[..., :nope], p["w_uk"])
        if whole:                                    # every head already
            self._repeat("w_uk", 2 * q[..., :nope].numel()
                         * p["w_uk"].shape[0])
            qa = torch.cat([q_abs, q_rope], dim=-1)
        else:
            qa = self.comms.model.all_gather(torch.cat([q_abs, q_rope],
                                                       dim=-1))
            qa = qa.permute(1, 2, 0, 3, 4).reshape(B, 1, H, -1)
        r = lat_c.shape[-1]
        scale = 1.0 / math.sqrt(nope + cfg.qk_rope_dim)
        s = (torch.einsum("bshr,btr->bhst", qa[..., :r].float(),
                          lat_c.float())
             + torch.einsum("bshd,btd->bhst", qa[..., r:].float(),
                            kr_c.float())) * scale
        valid = (start + torch.arange(S_loc, device=h.device)) < n_valid
        s = torch.where(valid, s, NEG_INF)
        mx = s.amax(dim=-1)                                   # (B, H, 1)
        pr = torch.where(valid, torch.exp(s - mx[..., None]), 0.0)
        part = torch.cat([torch.einsum("bhst,btr->bhsr", pr, lat_c.float()),
                          mx[..., None], pr.sum(dim=-1)[..., None]], dim=-1)
        g = part[None] if s0 is None else self.comms.model.all_gather(part)
        o, m_r, l_r = g[..., :r], g[..., r], g[..., r + 1]    # (M, B, H, 1)
        w = torch.exp(m_r - m_r.amax(dim=0))
        ctx = (o * w[..., None]).sum(dim=0) / (l_r * w).sum(dim=0)[..., None]
        # the rank's wo rows: columns [c0, c0 + R) of the (H·v_head) output
        R = p["wo"].shape[0]
        split = _split_dim(specs["wo"], "model") is not None
        c0 = self.m * R if split else 0
        if whole:
            self._repeat("w_uv", 2 * ctx.numel() * vd)
            out = torch.einsum("bshr,rhd->bshd", ctx.permute(0, 2, 1, 3),
                               p["w_uv"].float()).flatten(2)[..., c0:c0 + R]
        else:                                  # the rank's R / v_head heads
            mine = ctx[:, c0 // vd:(c0 + R) // vd].permute(0, 2, 1, 3)
            out = torch.einsum("bshr,rhd->bshd", mine,
                               p["w_uv"].float()).flatten(2)
        y = self._mm("wo", out.to(h.dtype), p["wo"], not split)
        return self.comms.model.all_reduce(y) if split else y

    # -- RG-LRU ------------------------------------------------------------------
    def _rglru(self, p: dict, h, cache=None):
        """Kind "R" on the rank's channels [m·d/M, (m+1)·d/M) (module
        notes): its x and gate columns, conv, gates and scan; the gate
        products read the whole x branch (gathered over the model
        column); ``w_out``'s rows of the channels, then an all-reduce.
        ``cache`` (decode): the rank's {"conv", "h"} block, written in
        place."""
        cfg = self.cfg
        B, S, _ = h.shape
        xb = self._mm("w_x", h, p["w_x"])
        gate = nn.functional.gelu(self._mm("w_gate", h, p["w_gate"]).float(),
                                  approximate="tanh")
        xb, new_conv = rglru._conv(xb, p["conv_w"], p["conv_b"],
                                   None if cache is None else cache["conv"])
        whole = ranks.all_gather(self.comms.model, xb)      # (M, B, S, d/M)
        whole = whole.permute(1, 2, 0, 3).reshape(B, S, -1)
        a, gin = rglru._lru_gates(SimpleNamespace(**p), xb, cfg, whole)
        if cache is None:
            y = rglru.linear_scan(a, gin)
        else:
            y = cache["h"] * a[:, 0] + gin[:, 0]
            cache["conv"].copy_(new_conv)
            cache["h"].copy_(y)
            y = y[:, None, :]
        y = (y * gate).to(h.dtype)
        return ranks.all_reduce(self.comms.model,
                                self._mm("w_out", y, p["w_out"]))

    # -- Mamba-2 -----------------------------------------------------------------
    def _mamba(self, p: dict, h, cache=None):
        """Kind "S" on the rank's heads (module notes): ``in_proj``'s and
        the conv's whole columns (gathered over the model column) give the
        heads' z, x and dt and the shared B and C; the SSD on the heads;
        ``out_norm`` over the whole d_inner through an all-reduce of the
        sum of squares; ``out_proj``'s rows of the heads, then an
        all-reduce.  ``cache`` (decode): the rank's {"conv", "ssm"}
        block, written in place (the conv state gathered over the model
        column for the step)."""
        cfg = self.cfg
        di, H, P, N, G = mamba2._dims(cfg)
        Hl = H // self.M
        h0 = self.m * Hl                     # the rank's heads [h0, h0 + Hl)
        dev = h.device
        mine = torch.arange(h0 * P, (h0 + Hl) * P, device=dev)
        bc = torch.arange(2 * G * N, device=dev)
        w = p["in_proj"]
        z, dt = (self._mm("in_proj", h, w.index_select(1, c)) for c in (
            mine, 2 * di + 2 * G * N + h0 + torch.arange(Hl, device=dev)))
        # the conv channels of the heads' x and of B and C
        chan = torch.cat([mine, di + bc])
        conv_w, conv_b = (p["conv_w"].index_select(-1, chan),
                          p["conv_b"].index_select(-1, chan))
        heads = torch.arange(h0, h0 + Hl, device=dev)
        dt_bias, A_log, D = (p[k].index_select(0, heads)
                             for k in ("dt_bias", "A_log", "D"))
        rep = H // G
        if cache is None:
            xs = self._mm("in_proj", h, w.index_select(1, di + mine))
            BC = self._mm("in_proj_bc", h, w[:, 2 * di: 2 * di + 2 * G * N],
                          True)
            xBC = mamba2._causal_conv(torch.cat([xs, BC], dim=-1), conv_w,
                                      conv_b)
            B_, S = h.shape[:2]
            Q = min(cfg.ssm_chunk, S)
            if S % Q:
                raise ValueError(f"seq {S} not divisible by ssd chunk {Q}")
            shape = (B_, S)
        else:
            xBC = self._conv_step(cache, h[:, 0], w, conv_w, conv_b, chan,
                                  h.dtype)
            shape = (h.shape[0],)
        xs = xBC[..., :Hl * P].reshape(*shape, Hl, P)
        Bm, Cm = (xBC[..., Hl * P + j * G * N: Hl * P + (j + 1) * G * N]
                  .reshape(*shape, G, N).repeat_interleave(rep, dim=-2)
                  .index_select(-2, heads) for j in (0, 1))
        dt = nn.functional.softplus(dt.float() + dt_bias)
        if cache is None:
            y = mamba2.ssd(xs, Bm, Cm, dt, -torch.exp(A_log), Q)
            y = y + xs.float() * D[None, None, :, None]
        else:
            y, ssm = mamba2.ssm_step(cache["ssm"], xs, Bm, Cm, dt[:, 0],
                                     -torch.exp(A_log), D)
            cache["ssm"].copy_(ssm)
            y = y[:, None]
        y = y.reshape(*h.shape[:2], Hl * P)
        y = self._out_norm(p["out_norm"]["scale"],
                           (y * nn.functional.silu(z.float())).to(h.dtype),
                           di)
        return ranks.all_reduce(self.comms.model,
                                self._mm("out_proj", y, p["out_proj"]))

    def _conv_step(self, cache: dict, x, w, conv_w, conv_b, chan, dtype):
        """One token of the Mamba-2 conv on the channels ``chan``: the
        conv state gathered whole over the model column (its channel
        block does not line up with the heads), the whole packed x|B|C
        input of the token computed (every model position alike), the
        rank's block of the new state written back."""
        cfg = self.cfg
        di, _, _, N, G = mamba2._dims(cfg)
        state = cache["conv"]
        cd = di + 2 * G * N
        split = state.shape[-1] != cd
        if split:
            g = self.comms.model.all_gather(state)       # (M, B, K-1, cd/M)
            state = g.permute(1, 2, 0, 3).reshape(*state.shape[:2], cd)
        xBC = self._mm("in_proj_xbc", x, w[:, di: 2 * di + 2 * G * N], True)
        conv_in = torch.cat([state, xBC[:, None, :].to(state.dtype)], dim=1)
        acc = torch.einsum("bkd,kd->bd", conv_in.index_select(-1, chan)
                           .float(), conv_w)
        new = conv_in[:, 1:]
        if split:
            cl = cache["conv"].shape[-1]
            new = new[..., self.m * cl:(self.m + 1) * cl]
        cache["conv"].copy_(new)
        return nn.functional.silu(acc + conv_b).to(dtype)

    def _out_norm(self, scale, y, width: int):
        """``layers.rmsnorm`` (eps 1e-6) of rows whose whole spans the model
        column's blocks: the sum of squares all-reduced over the column in
        fp32 (its gradient summed back over the column: each position
        scales only its own block by it), ``scale`` the rank's block."""
        yf = y.float()
        ss = ranks.sum_grad(self.comms.model, ranks.all_reduce(
            self.comms.model, torch.sum(yf * yf, dim=-1, keepdim=True)))
        return (yf * torch.rsqrt(ss / width + 1e-6) * scale).to(y.dtype)

    # -- MoE ---------------------------------------------------------------------
    def _moe(self, p: dict, specs: dict, h):
        """Kind "M"'s FFN (module notes): the whole router (gathered over
        the data column) routes the rank's rows as one device routes them,
        every model position alike; the rank's experts [m·E/M,
        (m+1)·E/M) run on their slots, their blocks gathered over the data
        column ``EXPERT_CHUNK_BYTES`` at a time; an all-reduce over the
        model column sums the partial outputs."""
        cfg = self.cfg
        B, S, d = h.shape
        # replicated over "model": its gradient summed over the column
        router = self._gather(ranks.sum_grad(self.comms.model, p["router"]),
                              specs["router"], "data")
        self._repeat("router", 2 * h.numel() * router.shape[-1])
        pl = moe.plan(SimpleNamespace(router=router), h, cfg)
        del router
        n = p["w_gate"].shape[0]                     # the rank's experts
        e0 = self.m * n
        whole = sum(t[0].numel() * t.element_size() * self.A
                    for t in (p["w_gate"], p["w_up"], p["w_down"]))
        chunk = max(1, EXPERT_CHUNK_BYTES // whole)
        out = torch.zeros((B * S, d), dtype=h.dtype, device=h.device)
        for c0 in range(0, n, chunk):
            w = [self._gather(p[k][c0:c0 + chunk], specs[k], "data")
                 for k in ("w_gate", "w_up", "w_down")]
            out = moe.experts(h, pl, *w, e0 + c0, out)
            del w
        return ranks.all_reduce(self.comms.model, out.reshape(B, S, d))

    # -- layers -------------------------------------------------------------------
    def _apply_layer(self, i: int, x, positions, at=None):
        blocks, specs = self._layer(i)
        kind = self.cfg.layers[i]
        eps = self.cfg.norm_eps
        h = ranks.sum_grad(self.comms.model,
                           rmsnorm(blocks["ln1"]["scale"], x, eps))
        if kind == "R":
            x = x + self._rglru(self._gathered(blocks["rglru"],
                                               specs["rglru"]), h, at)
        elif kind == "S":
            x = x + self._mamba(self._gathered(
                blocks["mamba"], specs["mamba"],
                ("in_proj", "conv_w", "conv_b")), h, at)
        elif kind == "L":
            heads = () if at is not None else MLA_HEADS
            x = x + self._mla(self._gathered(blocks["mla"], specs["mla"],
                                             heads), specs["mla"], h,
                              positions, at)
        else:
            attn = self._gathered(blocks["attn"], specs["attn"],
                                  () if self.head_parallel else ("wq", "wo"))
            x = x + self._attention(attn, h, positions, kind == "W", at)
            del attn
        del h
        ffn = FFN_KINDS[kind]
        if ffn is None:
            return x
        h = ranks.sum_grad(self.comms.model,
                           rmsnorm(blocks["ln2"]["scale"], x, eps))
        if ffn == "moe":
            return x + self._moe(blocks["moe"], specs["moe"], h)
        mlp = self._gathered(blocks["mlp"], specs["mlp"])
        return x + ranks.all_reduce(self.comms.model,
                                    L.mlp_apply(SimpleNamespace(**mlp), h))

    def _unit(self, x, positions, r: int):
        n = len(self.unit)
        for i in range(r * n, (r + 1) * n):
            x = self._apply_layer(i, x, positions)
        return x

    def _final(self, x):
        x = rmsnorm(self.params["final_norm"]["scale"], x, self.cfg.norm_eps)
        return self._unembed(ranks.sum_grad(self.comms.model, x))

    def _input(self, x, r0: int, r1: int):
        """The rows [r0, r1) of an input: token ids (B, S) embedded
        through the rank's rows of the table, or an embeddings config's
        (B, S, d) embeddings, which need no table."""
        if self.cfg.input_mode == "embeddings" and x.dim() == 3:
            return x[r0:r1].to(L.torch_dtype(self.cfg.dtype))
        return self._embed(x[r0:r1])

    def _positions(self, positions, r0: int, r1: int, S: int, start: int,
                   device):
        """The rows' positions: the batch's ((B, S), or (3, B, S) for
        M-RoPE, rows on the second axis as ``batch_specs`` places them),
        or start, start + 1, ... (broadcast to (3, rows, S) for
        M-RoPE)."""
        if positions is not None:
            return positions[..., r0:r1, :]
        pos = torch.arange(start, start + S, device=device)[None, :] \
            .expand(r1 - r0, S)
        return pos[None].expand(3, r1 - r0, S) \
            if self.cfg.rope_kind == "mrope" else pos

    # -- entry points -------------------------------------------------------------
    def forward(self, batch: dict) -> torch.Tensor:
        """The prefill forward of the whole batch (``Model.apply``'s
        arguments: "tokens" (B, S), or "embeddings" (B, S, d) for an
        embeddings config; "positions" optional): this rank's logits
        block, (its batch rows, S, padded_vocab / M) in the activation
        dtype.  While autograd records, each repeat of the layer unit is
        recomputed in the backward as ``cfg.remat`` says (module
        notes)."""
        if self._one is not None:
            return self._one.forward(batch)
        emb = self.cfg.input_mode == "embeddings" and "embeddings" in batch
        inp = batch["embeddings"] if emb else batch["tokens"]
        B, S = inp.shape[:2]
        r0, r1 = self._rows(B)
        positions = self._positions(batch.get("positions"), r0, r1, S, 0,
                                    inp.device)
        x = self._input(inp, r0, r1)
        remat = self.cfg.remat if torch.is_grad_enabled() else "none"
        n, R = len(self.unit), self.repeats
        for r in range(R):
            if remat == "none":
                x = self._unit(x, positions, r)
            else:
                x = ckpt.checkpoint(self._unit, x, positions, r,
                                    use_reentrant=False,
                                    context_fn=REMAT_CONTEXTS[remat])
        for i in range(n * R, self.cfg.num_layers):
            x = self._apply_layer(i, x, positions)
        return self._final(x)

    @torch.no_grad()
    def apply(self, batch: dict) -> torch.Tensor:
        """``forward`` without gradients (the serving prefill)."""
        return self.forward(batch)

    def cache_shapes(self, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
        """``Model.init_cache``'s whole cache as ``meta`` tensors in the
        reference's stacked layout (``Model.cache_tree``): the global
        shapes ``sharding.cache_specs`` places."""
        with dispatch.dry_run():
            model = Model(self.cfg, device="meta")
        return model.cache_tree(model.init_cache(batch, max_len, dtype))

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list[dict]:
        """This rank's block of ``Model.init_cache`` by ``cache_specs``,
        one dict a layer: its batch rows and, where a layer's slots
        (max_len, or a "W" layer's min(max_len, local_window)-slot ring)
        split over the model column, its contiguous slice of them."""
        if self._one is not None:
            return self._one.init_cache(batch, max_len, dtype=dtype)
        self.rows(batch)                     # a batch the axes cannot split
        shapes = self.cache_shapes(batch, max_len, dtype)
        specs = shd.cache_specs(self.cfg, shapes, self.mesh)
        local = unstack_cache(tree_map(lambda t, spec: shd.local_block(
            t, spec, self.mesh, self.comms.coords), shapes, specs))
        self._slots = [_slots(c) for c in unstack_cache(shapes)]
        return [{k: torch.zeros(t.shape, dtype=t.dtype, device=self.device)
                 for k, t in c.items()} for c in local]

    def cache_tree(self, cache: list[dict]) -> dict:
        """``cache`` (this rank's block) in the reference's stacked layout
        (``Model.cache_tree``): what an ``ECStateStore`` with the rank's
        communicator packs, by the specs of ``cache_shapes``."""
        return stack_cache(cache, len(self.unit), self.repeats)

    @torch.no_grad()
    def decode_step(self, cache: list[dict], tokens: torch.Tensor,
                    cur_len: int, positions=None):
        """``Model.decode_step`` of the whole batch's tokens (B,), or an
        embeddings config's (B, 1, d): writes this rank's cache block in
        place (a "W" layer at ring slot cur_len % local_window, attending
        over min(cur_len + 1, local_window) slots) and returns (this
        rank's logits block (its rows, padded_vocab / M), cache)."""
        if self._one is not None:
            return self._one.decode_step(cache, tokens, cur_len, positions)
        cur_len = int(cur_len)
        r0, r1 = self._rows(tokens.shape[0])
        x = self._input(tokens if tokens.dim() == 3 else tokens[:, None],
                        r0, r1)
        pos = self._positions(positions, r0, r1, 1, cur_len, x.device)
        W = self.cfg.local_window or 0
        for i, layer_cache in enumerate(cache):
            if self.cfg.layers[i] in "RS":           # recurrent state
                x = self._apply_layer(i, x, pos, layer_cache)
                continue
            slot, n_valid = cur_len, cur_len + 1
            if self.cfg.layers[i] == "W" and W:
                slot, n_valid = cur_len % W, min(cur_len + 1, W)
            S_loc = _slots(layer_cache)
            s0 = self.m * S_loc if S_loc != self._slots[i] else None
            x = self._apply_layer(i, x, pos, (layer_cache, slot, n_valid, s0))
        return self._final(x)[:, 0], cache

    def _batch_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows of ``t`` (this rank's rows first): an
        all-gather over the data (and pod) columns where the batch is
        split over them."""
        split = _batch_split(self._batch, self.A, self.P)
        if split == 1:
            return t
        t = self.comms.data.all_gather(t).flatten(0, 1)
        if split > self.A:                       # rows over (pod, data)
            t = self.comms.pod.all_gather(t).flatten(0, 1)
        return t

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole batch's greedy tokens (B,) from this rank's logits
        block of the last ``decode_step`` (module notes)."""
        if self._one is not None:
            return Model.argmax(logits)
        Vl = logits.shape[-1]
        idx = torch.argmax(logits, dim=-1)
        val = logits.gather(-1, idx[:, None])[:, 0]
        vals = self.comms.model.all_gather(val)          # (M, rows)
        ids = self.comms.model.all_gather(idx + self.m * Vl)
        tok = ids.gather(0, torch.argmax(vals, dim=0)[None])[0]
        return self._batch_gather(tok)

    def gathered_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole batch's logits (B, padded_vocab) of the last
        ``decode_step``, the same on every rank: this rank's block
        gathered over the model column, then over the data (and pod)
        columns."""
        if self._one is not None:
            return logits
        g = self.comms.model.all_gather(logits)          # (M, rows, V/M)
        return self._batch_gather(g.permute(1, 0, 2).flatten(1))

    def sample(self, logits: torch.Tensor, temperature: float,
               generator: torch.Generator) -> torch.Tensor:
        """``Model.sample`` of the whole batch's logits (``logits``):
        every rank draws every row from its generator, seeded alike on
        every rank, so every rank holds the one-device engine's tokens
        (module notes)."""
        return Model.sample(self.gathered_logits(logits), temperature,
                            generator)


def _slots(cache: dict):
    """A layer cache's slot count: its K ("k") or latent ("latent") slots,
    None for a recurrent state."""
    for key in ("k", "latent"):
        if key in cache:
            return cache[key].shape[1]
    return None


def _global_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's leaves' shapes (meta tensors)."""
    from .convert import param_tree
    with dispatch.dry_run():
        return param_tree(Model(cfg, device="meta"))


def _one_device(cfg: ModelConfig, params: dict):
    """A ``Model`` whose parameters are ``params``' tensors (a 1 x 1 mesh's
    blocks are whole leaves), not copies."""
    from .convert import param_tree
    dev = params["final_norm"]["scale"].device
    model = Model(cfg, device=dev)

    def bind(p, t):
        for dst, src in zip(*((x.parts if isinstance(x, Stacked) else [x])
                              for x in (p, t))):
            dst.data = src
    tree_map(bind, param_tree(model), params)
    return model


def init_blocks(cfg: ModelConfig, mesh, coords,
                generator: torch.Generator) -> dict:
    """The blocks at ``coords`` of ``Model(cfg).init(generator)``'s
    parameter tree, the same numbers, drawn one module at a time on the
    generator's device: no rank holds more than one layer whole.  Each
    block is the rank's own (contiguous) tensor."""
    from .convert import _nest, param_tree
    dev = torch.device(generator.device)
    with dispatch.dry_run():
        model = Model(cfg, device="meta")
    specs = shd.param_specs(cfg, param_tree(model), mesh)
    n, R = len(model.unit), model.repeats

    def drawn(module, spec_tree, *reset_args):
        module.to_empty(device=dev)
        module.reset(*reset_args)
        out = tree_map(lambda t, sp: shd.local_block(
            t.detach(), sp, mesh, coords).clone(
                memory_format=torch.contiguous_format),
            _nest(dict(module.named_parameters())), spec_tree)
        module.to_empty(device="meta")
        return out

    emb = drawn(model.embeddings, specs["embeddings"], generator)
    per_layer = []
    for i, layer in enumerate(model.layers):
        spec = (tree_map(lambda sp: shd.P(*sp[1:]), specs["blocks"][i % n])
                if i < n * R else specs["tail"][i - n * R])
        per_layer.append(drawn(layer, spec, generator))
    final = drawn(model.final_norm, specs["final_norm"])
    return {"embeddings": emb, "final_norm": final,
            "blocks": [tree_map(lambda *ts: Stacked(ts),
                                *(per_layer[r * n + u] for r in range(R)))
                       if R else None for u in range(n)],
            "tail": per_layer[n * R:]}
