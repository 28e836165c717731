"""A dense model on one rank of a (data, model) or (pod, data, model)
mesh: its forward, and its backward for training.

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
  (``batch_rows``).  The residual stream is replicated over "model".
  The forward sends nothing over "pod": the parameters are replicated
  over pods (the reference's ``sharding.py``: "pods replicate params for
  fast recovery");
* **attention, ``attn_parallel="seq"``** (the default): the reference's
  ``blockwise_attention`` stripes Q tiles of ``bq = min(attn_block_q,
  max(S // M, 16))`` rows over "model", tile t = l·M + m to stripe m,
  with S padded to a multiple of M·bq.  The rank projects its stripe's
  rows with the whole wq (its blocks gathered over the model column too),
  runs kernel 11 once on the stripe (``flash_attention(stripe=(bq, M,
  m))``, zero rows for the padding, as the reference pads q) against all
  keys, multiplies its rows by the whole wo and all-gathers the stripes
  back into the residual stream.  K and V are computed on every model
  position (replicated over "model", as in the reference);
* **attention, "head"** (or "auto" with H % M == 0): the rank computes
  its H/M query heads (its wq columns) against the KV heads they read,
  and its wo rows; an all-reduce over the model column sums the partial
  outputs, in the activation dtype;
* **MLP**: w_gate and w_up column-parallel, w_down row-parallel, an
  all-reduce after it (activation dtype);
* **embed / logits**: vocab over "model": a masked lookup in the rank's
  rows of the table, then an all-reduce; the logits stay the rank's
  vocab block ``(B_rows, S, V/M)``, the reference's ``shard_act(logits,
  "batch", None, "model")``;
* **decode**: the cache is the rank's block by ``cache_specs``: its
  batch rows, and the sequence over "model" in contiguous slices of
  max_len / M.  The new K/V are written by the rank whose slice holds
  slot ``cache_len``; each rank computes its slice's partial softmax sums
  (max, sum, weighted V) in fp32 and the model column combines them by
  log-sum-exp (an all-gather of the partials, summed in model order);
* **greedy sampling** (``argmax``): each rank's local (max, index), an
  all-gather over the model column (the first maximum wins, as
  ``torch.argmax``), then over the data (and pod) columns for the whole
  batch.

**Training** (``forward`` while autograd records): gradients land on the
rank's own blocks, through the collectives' backwards
(``distributed/ranks.py``).  A parameter gather's backward is a
reduce-scatter, so a block's gradient sums every position's use of the
whole leaf; the input of each column-parallel product (the normed
residual before attention, before the MLP and before the unembedding)
passes through ``ranks.sum_grad``, which sums its gradient over the
model column, as do the wk and wv blocks (replicated over "model", and
every model position's K and V serve only its own query rows or heads);
the row-parallel all-reduces pass their gradient through, and the
"seq" stripes' gather hands each position its rows' gradient.  A
replicated norm scale then has its whole gradient on every model
position of a data column; the train step sums the leaves that "data"
does not split over the data column, and every leaf over the pods
(``train/train_step.py``).  ``cfg.remat`` is honoured as ``Model``
honours it: under "full" each repeat of the layer unit is recomputed in
the backward, its blocks gathered again.

Every result is the one-device model's up to the order of sums.  The
arithmetic a rank shares with ``Model`` is ``layers.py``'s own (RoPE,
the embedding lookup, the SwiGLU MLP, the unembedding, kernel 11's
route, the unsharded decode attention); what is this module's is the
split: which rows, heads and slices a rank computes and how blocks move.
Layer kinds other than "A" with a dense MLP, and the options the three
dense archs do not use (M-RoPE, embeddings inputs, int8 KV, softcaps),
raise on a mesh larger than 1 x 1, naming the ROADMAP item that will port
them.  ``READ_FIELDS``, ``REFUSED_FIELDS`` and ``KIND_FIELDS`` say, for
every ``ModelConfig`` field, whether the rank path reads it, refuses it
or leaves it to a refused layer kind; a field in none of them fails the
rank tests, so a new option of the dense path cannot go unread here.
On a 1 x 1 mesh ``RankModel`` is today's ``Model`` on the rank's (whole)
blocks, and ``params`` are that model's parameters (sharing the blocks'
storage).

``repeated`` counts, by product, the matrix-product FLOPs that every
model position computes alike (the plan's repeats: K and V everywhere,
and in a "seq" decode step wq and wo too); the dry run reports them
beside a rank's count (``launch/dryrun.py``).
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
from .config import ModelConfig
from .layers import NEG_INF, rmsnorm
from .transformer import REMAT_CONTEXTS

#: ROADMAP.md Queue 1 items that will port the rest across ranks
ROADMAP_ITEMS = {
    "M": (7, "MoE experts over 'model'"),
    "L": (8, "MLA"),
    "S": (9, "Mamba-2"),
    "R": (10, "RG-LRU"),
    "W": (11, "local attention and the other attention options"),
}
_OPTIONS_ITEM = ROADMAP_ITEMS["W"]

#: ``ModelConfig`` fields the rank path reads as ``Model``'s dense path
#: does (``remat``: honoured while autograd records, as ``Model.forward``
#: honours it; a forward without gradients ignores it alike)
READ_FIELDS = frozenset({
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "head_dim", "layer_pattern", "rope_theta",
    "attn_block_q", "attn_block_kv", "attn_parallel", "tie_embeddings",
    "norm_eps", "dtype", "remat"})

#: fields whose value, where ``refuses`` holds, the rank path lacks: on a
#: mesh larger than 1 x 1 such a config raises (ROADMAP Queue 1 item 11);
#: otherwise the field is read as ``Model`` reads it
REFUSED_FIELDS = {
    "rope_kind": ("M-RoPE", lambda v: v == "mrope"),
    "mrope_sections": ("M-RoPE sections", bool),
    "input_mode": ("an embeddings input", lambda v: v != "tokens"),
    "kv_cache_dtype": ("the int8 KV cache", lambda v: v == "int8"),
    "attn_logit_softcap": ("an attention logit softcap", bool),
    "logit_softcap": ("a logit softcap", bool),
}

#: fields only the layer kinds the rank path refuses read
KIND_FIELDS = {
    "W": ("local_window",),
    "L": ("q_lora_rank", "kv_lora_rank", "qk_nope_dim", "qk_rope_dim",
          "v_head_dim"),
    "M": ("num_experts", "experts_per_token", "moe_capacity_factor"),
    "S": ("ssm_state", "ssm_expand", "ssm_headdim", "ssm_conv", "ssm_chunk",
          "ssm_groups"),
    "R": ("rglru_conv", "rglru_c"),
}


def unclassified_fields() -> set:
    """``ModelConfig`` fields in none of the three tables above (none, or
    a new option was added without saying what the rank path does)."""
    known = READ_FIELDS | set(REFUSED_FIELDS) | {
        f for fields in KIND_FIELDS.values() for f in fields}
    return {f.name for f in dataclasses.fields(ModelConfig)} - known


def _refuse(cfg: ModelConfig, what: str, item) -> None:
    n, name = item
    raise NotImplementedError(
        f"{cfg.name}: {what} across ranks is not ported yet; ROADMAP.md "
        f"Queue 1 item {n} ({name}) ports it")


MESH_AXES = (("data", "model"), ("pod", "data", "model"))


def check_config(cfg: ModelConfig, mesh) -> None:
    """Raise unless ``cfg`` runs across ranks on ``mesh`` (module notes);
    every config runs on a 1 x 1 mesh."""
    if mesh.size == 1:
        return
    if tuple(mesh.axis_names) not in MESH_AXES:
        raise ValueError(f"a model across ranks takes a (data, model) or "
                         f"(pod, data, model) mesh, not {mesh.axis_names}")
    for kind in sorted(set(cfg.layers) - {"A"}):
        _refuse(cfg, f"layer kind {kind!r}", ROADMAP_ITEMS[kind])
    for field, (what, refuses) in REFUSED_FIELDS.items():
        if refuses(getattr(cfg, field)):
            _refuse(cfg, what, _OPTIONS_ITEM)
    M = mesh.shape["model"]
    for what, n in (("d_ff", cfg.d_ff), ("the padded vocab",
                                          cfg.padded_vocab)):
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
    """A dense config's forward and backward on this rank (module notes).

    ``params``: the rank's blocks of the parameter tree in the
    reference's layout (``convert.param_tree`` cut by
    ``sharding.local_block`` at the rank's coordinates; a training rank's
    own copies, which the optimizer updates in place); ``comms``: the
    rank's ``ranks.AxisComms`` (default: the ones
    ``layers.set_activation_mesh`` installed).  ``apply``, ``forward``
    (the same, recording gradients when autograd does) and
    ``decode_step`` take the whole batch and return the rank's logits
    block; ``argmax`` turns a decode step's logits block into the whole
    batch's greedy tokens.  ``ServeEngine`` drives it as it drives a
    ``Model``; ``train.train_step.make_rank_train_step`` trains it."""

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
        if repeated and self.M > 1:
            self.repeated[name] += 2 * x.numel() * w.shape[-1]
        return x @ w

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

    def _attention(self, p: dict, h, positions, cache=None, cache_len=None):
        cfg = self.cfg
        B, S, _ = h.shape
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        k = L.embed_positions(cfg, self._mm("wk", h, p["wk"], True)
                              .reshape(B, S, KV, hd), positions)
        v = self._mm("wv", h, p["wv"], True).reshape(B, S, KV, hd)
        if cache is not None:
            return self._decode_attention(p, h, positions, k, v, cache,
                                          cache_len)
        if self.head_parallel:
            Hl = H // self.M
            q = L.embed_positions(cfg, self._mm("wq", h, p["wq"])
                                  .reshape(B, S, Hl, hd), positions)
            kh, vh = self._kv_heads(k, v)
            out = self._flash(q, kh, vh)
            y = self._mm("wo", out.reshape(B, S, Hl * hd), p["wo"])
            return ranks.all_reduce(self.comms.model, y)
        st = seq_stripe(cfg, S, self.M, self.m)
        bq, rows, nv = st["bq"], st["rows"], st["valid"]
        idx = stripe_positions(rows, (bq, self.M, self.m), h.device)[:nv]
        q = self._mm("wq", h.index_select(1, idx), p["wq"])
        q = L.embed_positions(cfg, q.reshape(B, nv, H, hd),
                              positions.index_select(1, idx))
        # the reference's zero padding rows (none on most ranks: every
        # rank pads alike, so that their backward graphs match)
        q = nn.functional.pad(q, (0, 0, 0, 0, 0, rows - nv))
        out = self._flash(q, k, v, (bq, self.M, self.m))
        y = self._mm("wo", out[:, :nv].reshape(B, nv, H * hd), p["wo"])
        y = nn.functional.pad(y, (0, 0, 0, rows - nv))
        g = ranks.all_gather_rows(self.comms.model, y)  # (M, B, rows, d)
        g = g.reshape(self.M, B, st["n_local"], bq, -1).permute(1, 2, 0, 3, 4)
        return g.reshape(B, st["n_local"] * self.M * bq, -1)[:, :S]

    def _flash(self, q, k, v, stripe=None):
        """Kernel 11 (its plain version on the CPU) through the layers'
        route, recording its dispatch path."""
        self.op_paths["flash_attention"] = dispatch.decide(q).path
        return L.blockwise_attention(q, k, v, self.cfg, causal=True,
                                     stripe=stripe)

    def _decode_attention(self, p, h, positions, k, v, cache, cache_len):
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
        sharded = self._seq_sharded
        s0 = self.m * S_loc if sharded else 0
        if s0 <= cache_len < s0 + S_loc:
            cache["k"][:, cache_len - s0] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, cache_len - s0] = v[:, 0].to(cache["v"].dtype)
        if sharded:
            out = self._decode_combined(q, cache["k"], cache["v"], s0,
                                        cache_len + 1)
        else:
            out = L.decode_attention(q, cache["k"], cache["v"], cache_len + 1)
        if not self.head_parallel:
            return self._mm("wo", out.reshape(B, 1, H * hd), p["wo"], True)
        mine = out[:, :, self.m * Hl:(self.m + 1) * Hl].reshape(B, 1, Hl * hd)
        return self.comms.model.all_reduce(self._mm("wo", mine, p["wo"]))

    def _decode_combined(self, q, k_cache, v_cache, s0: int, n_valid: int):
        """Single-token attention over the model column's cache slices:
        this slice's partial max, sum and weighted V in fp32, all-gathered
        and combined by log-sum-exp in model order."""
        L._count("decode_ranked:torch")
        B, S, KV, hd = k_cache.shape
        H = q.shape[2]
        G = H // KV
        qg = q.reshape(B, KV, G, hd)
        s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                         k_cache.float()) / math.sqrt(hd)
        valid = (s0 + torch.arange(S, device=q.device)) < n_valid
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        mx = s.amax(dim=-1)
        pr = torch.exp(s - mx[..., None])
        part = torch.cat([torch.einsum("bkgs,bskh->bkgh", pr, v_cache.float()),
                          mx[..., None], pr.sum(dim=-1)[..., None]], dim=-1)
        g = self.comms.model.all_gather(part)        # (M, B, KV, G, hd + 2)
        o, m_r, l_r = g[..., :hd], g[..., hd], g[..., hd + 1]
        w = torch.exp(m_r - m_r.amax(dim=0))
        out = (o * w[..., None]).sum(dim=0) / (l_r * w).sum(dim=0)[..., None]
        return out.reshape(B, 1, H, hd).to(q.dtype)

    # -- layers -------------------------------------------------------------------
    def _apply_layer(self, i: int, x, positions, cache=None, cache_len=None):
        blocks, specs = self._layer(i)
        attn = self._gathered(blocks["attn"], specs["attn"],
                              () if self.head_parallel else ("wq", "wo"))
        eps = self.cfg.norm_eps
        h = ranks.sum_grad(self.comms.model,
                           rmsnorm(blocks["ln1"]["scale"], x, eps))
        x = x + self._attention(attn, h, positions, cache, cache_len)
        del attn, h
        mlp = self._gathered(blocks["mlp"], specs["mlp"])
        h = ranks.sum_grad(self.comms.model,
                           rmsnorm(blocks["ln2"]["scale"], x, eps))
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

    # -- entry points -------------------------------------------------------------
    def forward(self, batch: dict) -> torch.Tensor:
        """The prefill forward of the whole batch (``Model.apply``'s
        arguments): this rank's logits block, (its batch rows, S,
        padded_vocab / M) in the activation dtype.  While autograd
        records, each repeat of the layer unit is recomputed in the
        backward as ``cfg.remat`` says (module notes)."""
        if self._one is not None:
            return self._one.forward(batch)
        tokens = batch["tokens"]
        B, S = tokens.shape
        r0, r1 = self._rows(B)
        positions = batch.get("positions")
        positions = (torch.arange(S, device=tokens.device)[None, :]
                     .expand(r1 - r0, S) if positions is None
                     else positions[r0:r1])
        x = self._embed(tokens[r0:r1])
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

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list[dict]:
        """This rank's block of ``Model.init_cache`` by ``cache_specs``:
        its batch rows and, when max_len splits over the model column,
        its slice of max_len / M positions (else all of them)."""
        if self._one is not None:
            return self._one.init_cache(batch, max_len, dtype=dtype)
        cfg = self.cfg
        r0, r1 = self.rows(batch)
        self._seq_sharded = self.M > 1 and max_len % self.M == 0
        S = max_len // self.M if self._seq_sharded else max_len
        shape = (r1 - r0, S, cfg.num_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def decode_step(self, cache: list[dict], tokens: torch.Tensor,
                    cur_len: int, positions=None):
        """``Model.decode_step`` of the whole batch's tokens (B,): writes
        this rank's cache block in place and returns (this rank's logits
        block (its rows, padded_vocab / M), cache)."""
        if self._one is not None:
            return self._one.decode_step(cache, tokens, cur_len, positions)
        cur_len = int(cur_len)
        r0, r1 = self._rows(tokens.shape[0])
        x = self._embed(tokens[r0:r1, None])
        pos = (torch.full((r1 - r0, 1), cur_len, dtype=torch.int64,
                          device=x.device) if positions is None
               else positions[r0:r1])
        for i, layer_cache in enumerate(cache):
            x = self._apply_layer(i, x, pos, layer_cache, cur_len)
        return self._final(x)[:, 0], cache

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole batch's greedy tokens (B,) from this rank's logits
        block of the last ``decode_step`` (module notes)."""
        if self._one is not None:
            return torch.argmax(logits, dim=-1)
        Vl = logits.shape[-1]
        idx = torch.argmax(logits, dim=-1)
        val = logits.gather(-1, idx[:, None])[:, 0]
        vals = self.comms.model.all_gather(val)          # (M, rows)
        ids = self.comms.model.all_gather(idx + self.m * Vl)
        tok = ids.gather(0, torch.argmax(vals, dim=0)[None])[0]
        split = _batch_split(self._batch, self.A, self.P)
        if split == 1:
            return tok
        tok = self.comms.data.all_gather(tok).reshape(-1)
        if split > self.A:                       # rows over (pod, data)
            tok = self.comms.pod.all_gather(tok).reshape(-1)
        return tok


def _global_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's leaves' shapes (meta tensors)."""
    from .convert import param_tree
    from .transformer import Model
    with dispatch.dry_run():
        return param_tree(Model(cfg, device="meta"))


def _one_device(cfg: ModelConfig, params: dict):
    """A ``Model`` whose parameters are ``params``' tensors (a 1 x 1 mesh's
    blocks are whole leaves), not copies."""
    from .convert import param_tree
    from .transformer import Model
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
    from .transformer import Model
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
