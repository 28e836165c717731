"""Model assembly: the decoder stack for every layer kind.

The port of the JAX package's ``models/transformer.py``.  The reference
groups layers into repeating *units* of ``cfg.layer_pattern`` and stacks
each unit position's parameters on a leading ``repeats`` axis for
``lax.scan``.  PyTorch runs eagerly, so here the layers sit in one
``nn.ModuleList`` in the reference's order - unit position ``u`` of
repeat ``r`` is layer ``r * len(unit) + u``, then the tail - and run in a
Python loop; ``models/convert.py`` unstacks a reference tree into it.
``forward`` (``model(batch)``) is the full-sequence forward; while
autograd records, each unit is recomputed in the backward as
``cfg.remat`` says (the reference's ``_remat``: "full" checkpoints the
unit, "dots" keeps its matrix products' outputs, "none" keeps
everything).  ``apply``, the serving forward, is ``forward`` without
gradients.  ``cache_tree`` shows a cache in the reference's stacked
layout.

Layer kinds (the reference's ``MIXER_KINDS``/``FFN_KINDS``): "A" global
attention + MLP, "W" local (windowed) attention + MLP, "M" global
attention + MoE, "L" MLA + MLP, "S" Mamba-2 alone, "R" RG-LRU + MLP.
Inputs are token ids, or with ``input_mode="embeddings"`` (the audio and
vision stubs) precomputed (B, S, d) embeddings; M-RoPE configs take (3,
B, S) positions.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..kernels import dispatch
from ..tree import Stacked, tree_map
from . import layers as L
from .config import ModelConfig
from .layers import (MLA, MLP, Attention, Embeddings, RMSNorm,
                     attention_apply, embed, mla_apply, mlp_apply,
                     torch_dtype, unembed)
from .mamba2 import Mamba2, mamba2_forward, mamba2_init_cache, mamba2_step
from .moe import MoE, moe_apply
from .rglru import RGLRU, rglru_forward, rglru_init_cache, rglru_step

MIXER_KINDS = {"A": "attn", "W": "attn", "M": "attn", "L": "mla",
               "S": "mamba", "R": "rglru"}
FFN_KINDS = {"A": "mlp", "W": "mlp", "L": "mlp", "R": "mlp", "M": "moe",
             "S": None}
_MIXERS = {"attn": Attention, "mla": MLA, "mamba": Mamba2, "rglru": RGLRU}
_FFNS = {"mlp": MLP, "moe": MoE}


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One layer of ``kind``: ln1 and its mixer (attn, mla, mamba or
    rglru), then, unless the kind has none, ln2 and its FFN (mlp or moe)
    - the reference's keys."""

    def __init__(self, kind: str, cfg: ModelConfig, device):
        super().__init__()
        if kind not in MIXER_KINDS:
            raise ValueError(f"unknown layer kind {kind!r}")
        self.kind = kind
        self.ln1 = RMSNorm(cfg.d_model, device)
        mixer = MIXER_KINDS[kind]
        setattr(self, mixer, _MIXERS[mixer](cfg, device))
        ffn = FFN_KINDS[kind]
        if ffn:
            self.ln2 = RMSNorm(cfg.d_model, device)
            setattr(self, ffn, _FFNS[ffn](cfg, device))

    def reset(self, generator: torch.Generator) -> None:
        self.ln1.reset()
        getattr(self, MIXER_KINDS[self.kind]).reset(generator)
        ffn = FFN_KINDS[self.kind]
        if ffn:
            self.ln2.reset()
            getattr(self, ffn).reset(generator)


def apply_layer(layer: Layer, x, cfg: ModelConfig, positions, *,
                cache=None, cache_len=None, valid_len=None):
    """Returns (x, new_cache)."""
    kind = layer.kind
    h = layer.ln1(x, cfg.norm_eps)
    mixer = MIXER_KINDS[kind]
    if mixer == "attn":
        out, new_cache = attention_apply(
            layer.attn, h, cfg, positions, local=(kind == "W"), cache=cache,
            cache_len=cache_len, valid_len=valid_len)
    elif mixer == "mla":
        out, new_cache = mla_apply(layer.mla, h, cfg, positions, cache=cache,
                                   cache_len=cache_len)
    elif mixer == "mamba":
        if cache is None:
            out, new_cache = mamba2_forward(layer.mamba, h, cfg), None
        else:
            out, new_cache = mamba2_step(layer.mamba, h, cfg, cache)
    else:
        if cache is None:
            out, new_cache = rglru_forward(layer.rglru, h, cfg), None
        else:
            out, new_cache = rglru_step(layer.rglru, h, cfg, cache)
    x = x + out
    ffn = FFN_KINDS[kind]
    if ffn:
        h = layer.ln2(x, cfg.norm_eps)
        x = x + (moe_apply(layer.moe, h, cfg) if ffn == "moe"
                 else mlp_apply(layer.mlp, h))
    return x, new_cache


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """The decoder on one device: ``init`` fills random weights from a
    generator, ``apply`` is the full-sequence (prefill) forward,
    ``init_cache``/``decode_step`` the token-by-token path.

    ``device=None`` means the card (it raises without one); pass
    ``device="cpu"`` to run on the CPU, where attention takes the flash
    kernel's plain version.
    """

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dev = dispatch.resolve_device(device)
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, dev)
        self.layers = nn.ModuleList(Layer(kind, cfg, dev)
                                    for kind in cfg.layers)
        self.final_norm = RMSNorm(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @property
    def unit(self) -> str:
        return self.cfg.layer_pattern

    @property
    def repeats(self) -> int:
        return self.cfg.num_layers // len(self.unit)

    @property
    def tail(self) -> str:
        return self.unit[: self.cfg.num_layers % len(self.unit)]

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights as the reference draws them (N(0, 0.02²) in
        fp32, cast to the parameter's dtype; norm scales 1), from
        ``generator``, which must live on the model's device.  The numbers
        differ from the reference's for any seed: load its weights with
        ``models.convert.params_from_jax`` to compare the two."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        self.embeddings.reset(generator)
        for layer in self.layers:
            layer.reset(generator)
        self.final_norm.reset()
        return self

    def describe(self) -> dict:
        """Where the model runs and how its attention calls went since
        ``layers.reset_op_paths()``: route -> calls (module notes of
        ``layers``)."""
        return {"device": str(self.device),
                "attention": dispatch.describe(self.device),
                "op_paths": dict(L.OP_PATHS)}

    # -- helpers ------------------------------------------------------------
    def _embed_in(self, batch: dict):
        cfg = self.cfg
        if cfg.input_mode == "embeddings" and "embeddings" in batch:
            x = batch["embeddings"].to(torch_dtype(cfg.dtype))
            B, S = x.shape[:2]
        else:
            x = embed(self.embeddings, batch["tokens"], cfg)
            B, S = batch["tokens"].shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
            if cfg.rope_kind == "mrope":
                positions = positions[None].expand(3, B, S)
        return x, positions

    # -- forward ------------------------------------------------------------
    @torch.no_grad()
    def apply(self, batch: dict) -> torch.Tensor:
        """The serving forward: ``forward`` without gradients.
        batch["tokens"]: (B, S) integers on the model's device, or for an
        embeddings config batch["embeddings"] (B, S, d); optional
        batch["positions"] ((B, S), or (3, B, S) for M-RoPE) -> logits
        (B, S, padded_vocab) in the activation dtype."""
        return self.forward(batch)

    def _unit(self, x, positions, r: int):
        n = len(self.unit)
        for layer in self.layers[r * n:(r + 1) * n]:
            x, _ = apply_layer(layer, x, self.cfg, positions)
        return x

    def forward(self, batch: dict) -> torch.Tensor:
        """The full-sequence forward (``apply``).  While autograd records,
        each repeat of the unit is recomputed in the backward as
        ``cfg.remat`` says (the tail layers are kept, as in the
        reference)."""
        cfg = self.cfg
        remat = cfg.remat if torch.is_grad_enabled() else "none"
        x, positions = self._embed_in(batch)
        for r in range(self.repeats):
            if remat == "full":
                x = ckpt.checkpoint(self._unit, x, positions, r,
                                    use_reentrant=False,
                                    context_fn=_count_once)
            elif remat == "dots":
                x = ckpt.checkpoint(self._unit, x, positions, r,
                                    use_reentrant=False,
                                    context_fn=_save_dots)
            else:
                x = self._unit(x, positions, r)
        for layer in self.layers[self.repeats * len(self.unit):]:
            x, _ = apply_layer(layer, x, cfg, positions)
        x = self.final_norm(x, cfg.norm_eps)
        return unembed(self.embeddings, x, cfg)

    # -- cache --------------------------------------------------------------
    def _layer_cache(self, kind: str, batch: int, max_len: int, dtype):
        cfg, dev = self.cfg, self.device
        mixer = MIXER_KINDS[kind]
        if mixer == "attn":
            S = max_len if kind != "W" else min(max_len, cfg.local_window)
            shape = (batch, S, cfg.num_kv_heads, cfg.head_dim)
            if cfg.kv_cache_dtype == "int8":
                return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                        "k_scale": torch.zeros(shape[:-1],
                                               dtype=torch.float32,
                                               device=dev),
                        "v_scale": torch.zeros(shape[:-1],
                                               dtype=torch.float32,
                                               device=dev)}
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if mixer == "mla":
            return {"latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                          dtype=dtype, device=dev),
                    "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                          dtype=dtype, device=dev)}
        if mixer == "mamba":
            return mamba2_init_cache(cfg, batch, dev)
        return rglru_init_cache(cfg, batch, dev)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list[dict]:
        """One cache per layer, in layer order (the reference stacks them
        per unit position): attention {"k", "v"} of (batch, max_len, KV,
        hd) in ``dtype`` (a "W" layer's ring holds min(max_len,
        local_window) slots; the int8 cache adds "k_scale" and "v_scale");
        MLA {"latent", "k_rope"}; Mamba-2 {"conv", "ssm"} and RG-LRU
        {"conv", "h"} in fp32."""
        return [self._layer_cache(layer.kind, batch, max_len, dtype)
                for layer in self.layers]

    def cache_tree(self, cache: list[dict]) -> dict:
        """``cache`` in the reference's layout (``stack_cache``)."""
        return stack_cache(cache, len(self.unit), self.repeats)

    # -- decode step ----------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: list[dict], tokens: torch.Tensor,
                    cur_len: int, positions=None):
        """tokens: (B,) integers, or (B, 1, d) embeddings for an embeddings
        config; cur_len: tokens already in the cache.  Writes this token's
        state into ``cache`` in place (a "W" layer at ring slot cur_len %
        local_window, attending over min(cur_len + 1, local_window)
        entries) and returns (logits (B, padded_vocab), cache)."""
        cfg = self.cfg
        B = tokens.shape[0]
        cur_len = int(cur_len)
        if cfg.input_mode == "embeddings" and tokens.dim() == 3:
            x = tokens.to(torch_dtype(cfg.dtype))
        else:
            x = embed(self.embeddings, tokens[:, None], cfg)
        if positions is None:
            pos = torch.full((B, 1), cur_len, dtype=torch.int64,
                             device=x.device)
            if cfg.rope_kind == "mrope":
                pos = pos[None].expand(3, B, 1)
        else:
            pos = positions
        W = cfg.local_window or 0
        for layer, layer_cache in zip(self.layers, cache):
            if layer.kind == "W" and W:
                x, _ = apply_layer(layer, x, cfg, pos, cache=layer_cache,
                                   cache_len=cur_len % W,
                                   valid_len=min(cur_len + 1, W))
            else:
                x, _ = apply_layer(layer, x, cfg, pos, cache=layer_cache,
                                   cache_len=cur_len)
        x = self.final_norm(x, cfg.norm_eps)
        return unembed(self.embeddings, x, cfg)[:, 0], cache

    @staticmethod
    def argmax(logits: torch.Tensor) -> torch.Tensor:
        """Greedy tokens (B,) of a decode step's logits (B, V): the first
        maximum, as the reference's ``jnp.argmax`` (a ``RankModel`` gathers
        its vocab-sharded one)."""
        return torch.argmax(logits, dim=-1)

    @staticmethod
    def sample(logits: torch.Tensor, temperature: float,
               generator: torch.Generator) -> torch.Tensor:
        """Tokens (B,) drawn from softmax(logits / temperature) in fp32,
        one ``torch.multinomial`` call on ``generator`` (a ``RankModel``
        draws from its gathered logits)."""
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]


def stack_cache(cache: list[dict], unit: int, repeats: int) -> dict:
    """A cache of one dict a layer in the reference's layout: {"blocks":
    one layer cache per position of a unit of ``unit`` layers, each leaf
    stacked over the ``repeats``, "tail": the remainder layers'} - the
    same tensors, not copies."""
    blocks = [tree_map(lambda *ts: Stacked(ts),
                       *(cache[r * unit + u] for r in range(repeats)))
              if repeats else None for u in range(unit)]
    return {"blocks": blocks, "tail": list(cache[repeats * unit:])}


def unstack_cache(tree: dict) -> list[dict]:
    """``stack_cache``'s inverse: one dict a layer, in layer order."""
    blocks = [b for b in tree["blocks"] if b is not None]
    repeats = len(next(iter(blocks[0].values())).parts) if blocks else 0
    return [tree_map(lambda x: x.parts[r], b) for r in range(repeats)
            for b in blocks] + list(tree["tail"])


def _count_once():
    """Checkpoint contexts (forward, recompute): the recompute does not
    count its calls again (``layers.recomputing``)."""
    return contextlib.nullcontext(), L.recomputing()


def _save_dots():
    """Selective-checkpoint contexts that keep matrix products' outputs
    (the reference's ``dots_with_no_batch_dims_saveable``: ``x @ w``
    reaches ``aten.mm``) and recompute the rest, the recompute counting
    nothing again."""
    fwd, rec = ckpt.create_selective_checkpoint_contexts(_dots_policy)
    return fwd, _both(rec, L.recomputing())


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _dots_policy(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


#: ``cfg.remat`` -> the checkpoint contexts of a unit's recompute (the
#: rank path's, ``models/ranked.py``; ``Model.forward`` names them alike)
REMAT_CONTEXTS = {"full": _count_once, "dots": _save_dots}
