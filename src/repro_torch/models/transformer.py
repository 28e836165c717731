"""Model assembly: the decoder stack for layer kind "A" (global GQA
attention + SwiGLU MLP).

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

Configs with any other layer kind, M-RoPE, embedding inputs, an int8 KV
cache or an attention logit softcap raise at construction.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..kernels import dispatch
from ..tree import Stacked, tree_map
from .config import ModelConfig
from .layers import (MLP, Attention, Embeddings, RMSNorm, attention_apply,
                     embed, mlp_apply, unembed)

_ROADMAP = "ROADMAP.md, Queue 1 item 3"
#: what each unported layer kind is, for the error
_UNPORTED_KINDS = {"W": "local (windowed) attention", "L": "MLA",
                   "M": "MoE", "S": "Mamba-2", "R": "RG-LRU"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this port cannot run."""
    for kind in sorted(set(cfg.layers)):
        if kind != "A":
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} "
                f"({_UNPORTED_KINDS.get(kind, 'unknown')}) is not ported "
                f"yet ({_ROADMAP})")
    unported = {"rope_kind": cfg.rope_kind == "mrope",
                "input_mode": cfg.input_mode == "embeddings",
                "kv_cache_dtype": cfg.kv_cache_dtype == "int8",
                "attn_logit_softcap": bool(cfg.attn_logit_softcap)}
    for field, bad in unported.items():
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                f"yet ({_ROADMAP})")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One "A" layer: ln1, attn, ln2, mlp (the reference's keys)."""

    def __init__(self, kind: str, cfg: ModelConfig, device):
        super().__init__()
        if kind != "A":
            raise NotImplementedError(f"layer kind {kind!r} ({_ROADMAP})")
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.mlp = MLP(cfg, device)

    def reset(self, generator: torch.Generator) -> None:
        self.ln1.reset()
        self.attn.reset(generator)
        self.ln2.reset()
        self.mlp.reset(generator)


def apply_layer(layer: Layer, x, cfg: ModelConfig, positions, *,
                cache=None, cache_len=None):
    """Returns (x, new_cache)."""
    h = layer.ln1(x, cfg.norm_eps)
    out, new_cache = attention_apply(layer.attn, h, cfg, positions,
                                     cache=cache, cache_len=cache_len)
    x = x + out
    h = layer.ln2(x, cfg.norm_eps)
    return x + mlp_apply(layer.mlp, h), new_cache


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
        check_supported(cfg)
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

    # -- helpers ------------------------------------------------------------
    def _embed_in(self, batch: dict):
        tokens = batch["tokens"]
        x = embed(self.embeddings, tokens, self.cfg)
        B, S = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        return x, positions

    # -- forward ------------------------------------------------------------
    @torch.no_grad()
    def apply(self, batch: dict) -> torch.Tensor:
        """The serving forward: ``forward`` without gradients.
        batch["tokens"]: (B, S) integers on the model's device -> logits
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
                                    use_reentrant=False)
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
    def _layer_cache(self, batch: int, max_len: int, dtype):
        cfg = self.cfg
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list[dict]:
        """One {"k", "v"} cache of (batch, max_len, KV, hd) per layer, in
        layer order (the reference stacks them per unit position)."""
        return [self._layer_cache(batch, max_len, dtype)
                for _ in self.layers]

    def cache_tree(self, cache: list[dict]) -> dict:
        """``cache`` in the reference's layout: {"blocks": one {"k", "v"}
        per unit position, each stacked over the repeats, "tail": the
        remainder layers'} - the port's tensors, not copies."""
        n = len(self.unit)
        blocks = [tree_map(lambda *ts: Stacked(ts),
                           *(cache[r * n + u] for r in range(self.repeats)))
                  if self.repeats else None for u in range(n)]
        return {"blocks": blocks, "tail": list(cache[self.repeats * n:])}

    # -- decode step ----------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: list[dict], tokens: torch.Tensor,
                    cur_len: int, positions=None):
        """tokens: (B,) integers; cur_len: tokens already in the cache.
        Writes this token's K/V into ``cache`` in place and returns
        (logits (B, padded_vocab), cache)."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = embed(self.embeddings, tokens[:, None], cfg)
        pos = (torch.full((B, 1), int(cur_len), dtype=torch.int64,
                          device=x.device) if positions is None
               else positions)
        for layer, layer_cache in zip(self.layers, cache):
            x, _ = apply_layer(layer, x, cfg, pos, cache=layer_cache,
                               cache_len=int(cur_len))
        x = self.final_norm(x, cfg.norm_eps)
        return unembed(self.embeddings, x, cfg)[:, 0], cache


def _save_dots():
    """Selective-checkpoint contexts that keep matrix products' outputs
    (the reference's ``dots_with_no_batch_dims_saveable``: ``x @ w``
    reaches ``aten.mm``) and recompute the rest."""
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


def _dots_policy(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE
