"""Core layers of the dense decoder: RMSNorm, RoPE, causal GQA attention
(prefill through the flash kernel, decode over a cache), SwiGLU and the
embeddings.

The port of the JAX package's ``models/layers.py``, for the layer kind
``"A"`` (global attention + MLP).  Conventions:

* parameters live in ``nn.Module``s under the reference's names
  (``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down``,
  ``embed``, ``unembed``, ``scale``) and shapes, so converting a
  reference parameter tree is mechanical (``models/convert.py``);
* activations are (batch, seq, ...) in ``cfg.dtype``; norms, RoPE and
  softmax run in fp32 and cast back; the embedding tables are fp32, as
  the reference makes them;
* one device, no mesh: the reference's ``shard_act`` and
  ``set_activation_mesh`` (GSPMD activation constraints) and its
  sequence- or head-parallel striping have no counterpart here.

Parameters are made with ``requires_grad=False``, as serving takes no
gradients; the training step (``train/train_step.py``) turns it on.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from .config import ModelConfig

NEG_INF = -1e30
_ROADMAP = "ROADMAP.md, Queue 1 item 3"


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter; ``init_normal`` or a weight load fills
    it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def init_normal(p: torch.Tensor, generator: torch.Generator,
                scale: float = 0.02) -> None:
    """Fill ``p`` with N(0, 1)·scale drawn in fp32 on its device, then
    cast, as the reference's ``_init`` does."""
    x = torch.randn(p.shape, generator=generator, device=p.device,
                    dtype=torch.float32)
    p.copy_(x.mul_(scale))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)

    def reset(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """The (head_dim/2,) inverse frequencies, in numpy float64 as the
    reference computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) integers."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions.float()[..., None] * freqs                 # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def position_embed(cfg: ModelConfig, q, k, positions):
    if cfg.rope_kind == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.rope_kind == "none":
        return q, k
    raise NotImplementedError(
        f"rope_kind {cfg.rope_kind!r} is not ported yet ({_ROADMAP})")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True,
                        q_offset: int = 0, window: int = 0, kv_mask=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd).

    Exact causal GQA attention over the full sequence: the reference's
    online-softmax scan over KV tiles, computed by
    ``kernels.flash_attention`` with the config's tile sizes (kernel 11
    on a CUDA tensor, its plain version on a CPU tensor).  One device:
    the reference's striping of Q tiles over a mesh's "model" axis has no
    counterpart.  A sliding window, a per-row ``kv_mask``, a ``q_offset``
    and a logit softcap are not ported: they raise.
    """
    if window or kv_mask is not None or q_offset or cfg.attn_logit_softcap:
        raise NotImplementedError(
            "blockwise_attention with a window, kv_mask, q_offset or logit "
            f"softcap (W layers, softcap configs) is not ported yet "
            f"({_ROADMAP})")
    return flash_attention(q, k, v, causal=causal, block_q=cfg.attn_block_q,
                           block_kv=cfg.attn_block_kv)


def decode_attention(q, k_cache, v_cache, cur_len: int,
                     softcap: float = 0.0):
    """Single-token attention over a (B, S, KV, hd) cache whose first
    ``cur_len`` entries are valid; scores in fp32.  Plain torch: the
    scores are (B, H, S), small for one token (not a Pallas kernel in the
    reference either)."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                          k_cache.float()) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    valid = (torch.arange(S, device=q.device) < cur_len)[None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


class Attention(nn.Module):
    """Global GQA attention (layer kind "A")."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        dt = torch_dtype(cfg.dtype)
        self.wq = _param((d, H * hd), dt, device)
        self.wk = _param((d, KV * hd), dt, device)
        self.wv = _param((d, KV * hd), dt, device)
        self.wo = _param((H * hd, d), dt, device)

    def reset(self, generator: torch.Generator) -> None:
        for p in (self.wq, self.wk, self.wv, self.wo):
            init_normal(p, generator)


def attention_apply(p: Attention, x, cfg: ModelConfig, positions, *,
                    cache: dict | None = None, cache_len: int | None = None):
    """x: (B, S, d).  Without a cache: causal attention over the whole
    sequence; returns (out, {"k", "v"} of this sequence).  With a cache
    (decode, S = 1): ``cache`` holds "k" and "v" of (B, Smax, KV, hd);
    the new K/V are written at ``cache_len`` **in place** (the reference
    returns a new cache) and attention runs over the first
    ``cache_len + 1`` entries; returns (out, cache)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, hd)
    k = (x @ p.wk).reshape(B, S, KV, hd)
    v = (x @ p.wv).reshape(B, S, KV, hd)
    q, k = position_embed(cfg, q, k, positions)
    if cache is None:
        out = blockwise_attention(q, k, v, cfg, causal=True)
        new_cache = {"k": k, "v": v}
    else:
        if S != 1:
            raise ValueError("the decode step is single-token")
        if "k_scale" in cache:
            raise NotImplementedError(
                f"the int8 KV cache is not ported yet ({_ROADMAP})")
        cache["k"][:, cache_len] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, cache_len] = v[:, 0].to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], cache_len + 1,
                               cfg.attn_logit_softcap)
        new_cache = cache
    return out.reshape(B, S, H * hd) @ p.wo, new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg.dtype)
        self.w_gate = _param((d, f), dt, device)
        self.w_up = _param((d, f), dt, device)
        self.w_down = _param((f, d), dt, device)

    def reset(self, generator: torch.Generator) -> None:
        for p in (self.w_gate, self.w_up, self.w_down):
            init_normal(p, generator)


def mlp_apply(p: MLP, x):
    h = nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

class Embeddings(nn.Module):
    """fp32 tables over the padded vocab: ``embed`` (V, d) and, unless
    tied, ``unembed`` (d, V)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = _param((V, d), torch.float32, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((d, V), torch.float32, device)

    def reset(self, generator: torch.Generator) -> None:
        init_normal(self.embed, generator)
        if hasattr(self, "unembed"):
            init_normal(self.unembed, generator)


def embed(p: Embeddings, tokens, cfg: ModelConfig):
    return p.embed[tokens].to(torch_dtype(cfg.dtype))


def unembed(p: Embeddings, x, cfg: ModelConfig):
    """Logits over the padded vocab, in the activation dtype."""
    if cfg.tie_embeddings:
        logits = x @ p.embed.to(x.dtype).T
    else:
        logits = x @ p.unembed.to(x.dtype)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
