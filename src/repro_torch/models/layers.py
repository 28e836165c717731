"""Core layers: RMSNorm, RoPE and M-RoPE, GQA attention (global, local
windows, int8 KV cache, logit softcap), MLA, SwiGLU and the embeddings.

The port of the JAX package's ``models/layers.py``.  Conventions:

* parameters live in ``nn.Module``s under the reference's names
  (``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down``,
  ``embed``, ``unembed``, ``scale``) and shapes, so converting a
  reference parameter tree is mechanical (``models/convert.py``);
* activations are (batch, seq, ...) in ``cfg.dtype``; norms, RoPE and
  softmax run in fp32 and cast back; the embedding tables are fp32, as
  the reference makes them;
* a mesh is a set of ranks: ``set_activation_mesh`` installs a rank's
  communicators (``distributed.ranks.rank_comms``) where the reference's
  installs a mesh for GSPMD's activation constraints, and
  ``models/ranked.py``'s ``RankModel`` runs a model of "A", "W", "L",
  "R" and "S" layers on the rank with the reference's activation layout
  (its ``shard_act`` calls), the sequence- or head-parallel attention of
  its ``blockwise_attention`` (kernel 11 on a stripe of Q tiles, or the
  masked route on the stripe's positions), MLA's ``_mla_blockwise`` on a
  stripe of Q tiles and the sequence-sharded decode cache.  ``Model``
  itself runs on one device and reads no mesh.

Parameters are made with ``requires_grad=False``, as serving takes no
gradients; the training step (``train/train_step.py``) turns it on.

Attention routes.  An unmasked causal prefill (layer kinds "A" and "M",
and "W" while the sequence fits one window) goes through
``kernels.flash_attention``: kernel 11 on a CUDA tensor, its plain
version on a CPU tensor.  A call with a sliding window, a per-row
``kv_mask``, a ``q_offset`` or a logit softcap is computed here in torch
(``_masked_blockwise``), as the reference computes it in its jnp scan
and not in its Pallas kernel: Q and KV tiles of the config's sizes, an
online softmax in fp32, tiles that the causal and window masks empty
skipped, so no (Sq, Skv) tensor per head is built.  MLA and every decode
step are plain torch, as in the reference.  ``OP_PATHS`` counts the
calls of each route (``Model.describe()`` shows them).
"""
from __future__ import annotations

import collections
import contextlib
import math

import numpy as np
import torch
from torch import nn

from ..kernels import dispatch
from ..kernels.flash_attention import flash_attention, stripe_positions
from .config import ModelConfig

NEG_INF = -1e30

#: calls of each attention route since the last ``reset_op_paths``:
#: "flash_attention:<dispatch path>" (kernel 11 or its plain version),
#: "masked_blockwise:torch", "decode:torch", "decode_q8:torch",
#: "mla_blockwise:torch", "mla_decode:torch", and on a rank
#: "decode_ranked:torch" and "mla_decode_ranked:torch" (a
#: sequence-sharded cache's combined decode)
OP_PATHS: collections.Counter = collections.Counter()

#: the rank communicators ``set_activation_mesh`` installed, or None
_ACT_MESH = None


def set_activation_mesh(comms) -> None:
    """Install (or clear, with None) this rank's communicators of a
    (data, model) mesh (``distributed.ranks.rank_comms``), what
    ``ranked.RankModel`` moves blocks through; the reference's
    ``set_activation_mesh`` installs the mesh GSPMD constrains activations
    on."""
    global _ACT_MESH
    _ACT_MESH = comms


def activation_mesh():
    """The communicators ``set_activation_mesh`` installed, or None."""
    return _ACT_MESH

#: True while a checkpointed unit runs again in the backward
#: (``recomputing``): its calls were counted in the forward
_RECOMPUTING = False


def reset_op_paths() -> None:
    OP_PATHS.clear()


@contextlib.contextmanager
def recomputing():
    """The context of a remat recompute (``Model.forward``): ``OP_PATHS``
    and ``moe.DROPS`` count each layer once per forward, not again when
    ``torch.utils.checkpoint`` recomputes it."""
    global _RECOMPUTING
    prev, _RECOMPUTING = _RECOMPUTING, True
    try:
        yield
    finally:
        _RECOMPUTING = prev


def counting() -> bool:
    """Whether calls count now (not inside ``recomputing``)."""
    return not _RECOMPUTING


def _count(route: str) -> None:
    if counting():
        OP_PATHS[route] += 1


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


#: elements drawn at once by ``init_normal`` (4 GB of fp32): a larger
#: tensor - a full-width expert stack, 5.6e9 elements at kimi-k2 - is
#: filled slice by slice along its first dimension, so its fp32 copy is
#: never made whole; a smaller one is drawn in one call
INIT_CHUNK = 1 << 30


@torch.no_grad()
def init_normal(p: torch.Tensor, generator: torch.Generator,
                scale: float = 0.02) -> None:
    """Fill ``p`` with N(0, 1)·scale drawn in fp32 on its device, then
    cast, as the reference's ``_init`` does; slices of at most
    ``INIT_CHUNK`` elements at a time."""
    if p.dim() == 0 or p.numel() <= INIT_CHUNK:
        x = torch.randn(p.shape, generator=generator, device=p.device,
                        dtype=torch.float32)
        p.copy_(x.mul_(scale))
        return
    step = max(1, INIT_CHUNK // max(1, p[0].numel()))
    for i in range(0, p.shape[0], step):
        init_normal(p[i:i + step], generator, scale)


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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]):
    """M-RoPE (Qwen2-VL): positions3 (3, B, S) for (t, h, w); the hd/2
    frequency pairs split into ``sections`` (summing to hd/2), each
    section rotated by its own position stream."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    sec_id = torch.as_tensor(np.repeat(np.arange(len(sections)), sections),
                             device=x.device)
    pos = positions3.float()[sec_id]                           # (half,B,S)
    ang = torch.movedim(pos, 0, -1) * freqs                    # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_positions(cfg: ModelConfig, x, positions):
    """``cfg.rope_kind``'s position embedding of q or k (B, S, heads, hd)."""
    if cfg.rope_kind == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope_kind == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


def position_embed(cfg: ModelConfig, q, k, positions):
    return (embed_positions(cfg, q, positions),
            embed_positions(cfg, k, positions))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True,
                        q_offset: int = 0, window: int = 0, kv_mask=None,
                        stripe=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd).

    The reference's online-softmax attention over KV tiles.  Query
    positions are ``q_offset + i``, key positions ``j``; ``causal`` keeps
    j <= i, ``window`` > 0 keeps i - j < window, ``kv_mask`` (B, Skv) bool
    marks each row's valid keys, and ``cfg.attn_logit_softcap`` caps the
    scaled scores with tanh.  Without any of those four the call goes to
    ``kernels.flash_attention`` (kernel 11 on a CUDA tensor); with any it
    runs ``_masked_blockwise`` in torch (module notes).

    On a rank of a mesh (``ranked.RankModel``) the reference stripes the
    Q tiles over the "model" axis: ``stripe=(bq, M, m)`` says that q holds
    stripe m's rows, tile t = l·M + m of bq rows at row l·bq (query
    position ``q_offset`` + ``stripe_positions``), and the call is one
    kernel-11 launch over them (``flash_attention(stripe=...)``), or with a
    masked option ``_masked_blockwise`` on those positions.
    """
    if window or kv_mask is not None or q_offset or cfg.attn_logit_softcap:
        _count("masked_blockwise:torch")
        return _masked_blockwise(q, k, v, cfg, causal=causal,
                                 q_offset=q_offset, window=window,
                                 kv_mask=kv_mask, stripe=stripe)
    _count(f"flash_attention:{dispatch.decide(q).path}")
    return flash_attention(q, k, v, causal=causal, block_q=cfg.attn_block_q,
                           block_kv=cfg.attn_block_kv, stripe=stripe)


def _masked_blockwise(q, k, v, cfg: ModelConfig, *, causal: bool,
                      q_offset: int, window: int, kv_mask, stripe=None):
    """Online softmax in fp32 over Q tiles of ``attn_block_q`` and KV tiles
    of ``attn_block_kv`` rows, GQA by head groups (no KV expansion): per
    tile s = q kᵀ / sqrt(hd), tanh-capped if the config says, masked to
    -1e30, then merged as the reference's ``kv_step`` merges it.  Query
    row r sits at position ``q_offset`` + r, or with ``stripe`` at
    ``q_offset`` + ``stripe_positions(Sq, stripe)[r]``.  A KV tile that the
    causal and window masks empty for a whole Q tile adds exactly 0 to a
    row that keeps any key, so it is skipped.  (A row that keeps no key
    has no defined output; the reference returns the mean of the values
    it visited.  No caller makes one: every query keeps its own key.)"""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    bq = min(cfg.attn_block_q, max(Sq, 16))
    bkv = min(cfg.attn_block_kv, Skv)
    softcap = cfg.attn_logit_softcap
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    pos = q_offset + stripe_positions(Sq, stripe, dev)
    host = (q_offset + stripe_positions(Sq, stripe)).tolist()  # no sync
    kf = k.permute(0, 2, 1, 3)                          # (B, KV, Skv, hd)
    vf = v.permute(0, 2, 1, 3)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, bq):
        q1 = min(Sq, q0 + bq)
        qt = q[:, q0:q1].float().reshape(B, q1 - q0, KV, G, hd) \
            .permute(0, 2, 3, 1, 4)                      # (B, KV, G, bq, hd)
        qp = pos[q0:q1, None]
        lo_pos = host[q0] - window + 1 if window else 0
        hi_pos = host[q1 - 1] if causal else Skv - 1
        acc = torch.zeros((B, KV, G, q1 - q0, hd), dtype=torch.float32,
                          device=dev)
        m_run = torch.full((B, KV, G, q1 - q0), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros_like(m_run)
        for k0 in range(0, Skv, bkv):
            k1 = min(Skv, k0 + bkv)
            if k0 > hi_pos or k1 - 1 < lo_pos:
                continue
            s = torch.einsum("bkgqd,bktd->bkgqt", qt,
                             kf[:, :, k0:k1].float()) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kp = torch.arange(k0, k1, device=dev)[None, :]
            mask = None
            if causal:
                mask = qp >= kp
            if window:
                w = qp - kp < window
                mask = w if mask is None else mask & w
            if mask is not None:
                mask = mask[None, None, None]
            if kv_mask is not None:
                row = kv_mask[:, None, None, None, k0:k1]
                mask = row if mask is None else mask & row
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            l = p.sum(dim=-1)
            o = torch.einsum("bkgqt,bktd->bkgqd", p, vf[:, :, k0:k1].float())
            m_new = torch.maximum(m_run, m)
            a = torch.exp(m_run - m_new)
            b = torch.exp(m - m_new)
            acc = acc * a[..., None] + o * b[..., None]
            l_run = l_run * a + l * b
            m_run = m_new
        res = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, q0:q1] = res.permute(0, 3, 1, 2, 4).reshape(
            B, q1 - q0, H, hd).to(q.dtype)
    return out


def local_attention(q, k, v, cfg: ModelConfig):
    """Sliding-window attention (the reference's ``_local_attention``):
    windows of ``cfg.local_window`` folded into the batch; each attends to
    itself and the previous window, window 0's zero-padded previous keys
    masked."""
    B, S, H, hd = q.shape
    W = cfg.local_window
    nW = -(-S // W)
    if nW * W != S:
        q = nn.functional.pad(q, (0, 0, 0, 0, 0, nW * W - S))
    kf, vf, kv_mask = _local_context(k, v, W)
    out = blockwise_attention(q.reshape(B * nW, W, H, hd), kf, vf, cfg,
                              causal=True, q_offset=W, window=W,
                              kv_mask=kv_mask)
    return out.reshape(B, nW * W, H, hd)[:, :S]


def local_attention_stripe(q, k, v, cfg: ModelConfig, stripe):
    """``local_attention`` on a rank of a mesh: the reference stripes each
    folded window's Q tiles over "model" (``blockwise_attention`` on the
    (B·nW, W) fold), so q (B, nW, rows, H, hd) holds stripe ``stripe``'s
    rows of every window (zero rows where the stripe passes the window or
    the sequence), against k, v (B, S, KV, hd) whole.  Returns q's
    shape."""
    B, nW, rows, H, hd = q.shape
    kf, vf, kv_mask = _local_context(k, v, cfg.local_window)
    out = blockwise_attention(q.reshape(B * nW, rows, H, hd), kf, vf, cfg,
                              causal=True, q_offset=cfg.local_window,
                              window=cfg.local_window, kv_mask=kv_mask,
                              stripe=stripe)
    return out.reshape(q.shape)


def _local_context(k, v, W: int):
    """Each window's keys and values, its previous window's then its own
    ((B·nW, 2W, KV, hd), the sequence zero-padded to whole windows), and
    the (B·nW, 2W) mask of the valid ones: window 0 has no previous."""
    B, S, KV, hd = k.shape
    nW = -(-S // W)
    if nW * W != S:
        pad = (0, 0, 0, 0, 0, nW * W - S)
        k, v = nn.functional.pad(k, pad), nn.functional.pad(v, pad)
    kw = k.reshape(B, nW, W, KV, hd)
    vw = v.reshape(B, nW, W, KV, hd)
    prev_k = torch.cat([torch.zeros_like(kw[:, :1]), kw[:, :-1]], dim=1)
    prev_v = torch.cat([torch.zeros_like(vw[:, :1]), vw[:, :-1]], dim=1)
    kf = torch.cat([prev_k, kw], dim=2).reshape(B * nW, 2 * W, KV, hd)
    vf = torch.cat([prev_v, vw], dim=2).reshape(B * nW, 2 * W, KV, hd)
    prev_valid = (torch.arange(nW, device=k.device) > 0)[None, :] \
        .expand(B, nW).reshape(B * nW)
    kv_mask = torch.cat([prev_valid[:, None].expand(B * nW, W),
                         torch.ones((B * nW, W), dtype=torch.bool,
                                    device=k.device)], dim=1)
    return kf, vf, kv_mask


def quantize_kv(x):
    """Per-vector symmetric int8 (the reference's ``_quantize_kv``): x
    (B, S, KV, hd) -> (int8, scale (B, S, KV) fp32).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127) \
        .to(torch.int8)
    return q, scale


def decode_attention_q8(q, k8, ks, v8, vs, cur_len: int,
                        softcap: float = 0.0):
    """int8-KV decode: the scales factored out of the dots and applied
    to the (B, KV, G, S) scores and probabilities."""
    _count("decode_q8:torch")
    B, S, KV, hd = k8.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                          k8.float()) / math.sqrt(hd)
    scores = scores * ks.permute(0, 2, 1)[:, :, None, :]
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    valid = (torch.arange(S, device=q.device) < cur_len)[None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    pv = p * vs.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgs,bskh->bkgh", pv, v8.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len: int,
                     softcap: float = 0.0):
    """Single-token attention over a (B, S, KV, hd) cache whose first
    ``cur_len`` entries are valid; scores in fp32.  Plain torch: the
    scores are (B, H, S), small for one token (not a Pallas kernel in the
    reference either)."""
    _count("decode:torch")
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
    """GQA attention (layer kinds "A", "M" and the windowed "W")."""

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
                    local: bool = False, cache: dict | None = None,
                    cache_len: int | None = None,
                    valid_len: int | None = None):
    """x: (B, S, d).  Without a cache: causal attention over the whole
    sequence (a ``local`` layer longer than ``cfg.local_window`` takes
    ``local_attention``); returns (out, {"k", "v"} of this sequence).
    With a cache (decode, S = 1): ``cache`` holds "k" and "v" of (B, Smax,
    KV, hd), and for the int8 cache "k_scale" and "v_scale" of (B, Smax,
    KV); the new K/V are written at slot ``cache_len`` **in place** (the
    reference returns a new cache) and attention runs over the first
    ``valid_len`` entries (default ``cache_len + 1``; a local layer's
    ring passes its own); returns (out, cache)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, hd)
    k = (x @ p.wk).reshape(B, S, KV, hd)
    v = (x @ p.wv).reshape(B, S, KV, hd)
    q, k = position_embed(cfg, q, k, positions)
    if cache is None:
        if local and cfg.local_window and cfg.local_window < S:
            out = local_attention(q, k, v, cfg)
        else:
            out = blockwise_attention(q, k, v, cfg, causal=True)
        new_cache = {"k": k, "v": v}
    else:
        if S != 1:
            raise ValueError("the decode step is single-token")
        n_valid = cache_len + 1 if valid_len is None else valid_len
        if "k_scale" in cache:                      # int8 KV cache
            k8, ks = quantize_kv(k)
            v8, vs = quantize_kv(v)
            cache["k"][:, cache_len] = k8[:, 0]
            cache["v"][:, cache_len] = v8[:, 0]
            cache["k_scale"][:, cache_len] = ks[:, 0].to(
                cache["k_scale"].dtype)
            cache["v_scale"][:, cache_len] = vs[:, 0].to(
                cache["v_scale"].dtype)
            out = decode_attention_q8(q, cache["k"], cache["k_scale"],
                                      cache["v"], cache["v_scale"], n_valid,
                                      cfg.attn_logit_softcap)
        else:
            cache["k"][:, cache_len] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, cache_len] = v[:, 0].to(cache["v"].dtype)
            out = decode_attention(q, cache["k"], cache["v"], n_valid,
                                   cfg.attn_logit_softcap)
        new_cache = cache
    return out.reshape(B, S, H * hd) @ p.wo, new_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """Layer kind "L": a low-rank latent KV (``w_dkv`` -> ``kv_norm``,
    up-projected per head by ``w_uk``/``w_uv``), a decoupled RoPE key
    ``k_rope`` shared by the heads, and queries through a LoRA
    (``w_dq`` -> ``q_norm`` -> ``w_uq``) or one ``wq``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        dt = torch_dtype(cfg.dtype)
        self.w_dkv = _param((d, r + rope), dt, device)
        self.kv_norm = RMSNorm(r, device)
        self.w_uk = _param((r, H, nope), dt, device)
        self.w_uv = _param((r, H, vdim), dt, device)
        self.wo = _param((H * vdim, d), dt, device)
        if qr:
            self.w_dq = _param((d, qr), dt, device)
            self.q_norm = RMSNorm(qr, device)
            self.w_uq = _param((qr, H, nope + rope), dt, device)
        else:
            self.wq = _param((d, H, nope + rope), dt, device)

    def reset(self, generator: torch.Generator) -> None:
        self.kv_norm.reset()
        for p in (self.w_dkv, self.w_uk, self.w_uv, self.wo):
            init_normal(p, generator)
        if hasattr(self, "w_dq"):
            self.q_norm.reset()
            init_normal(self.w_dq, generator)
            init_normal(self.w_uq, generator)
        else:
            init_normal(self.wq, generator)


def mla_apply(p: MLA, x, cfg: ModelConfig, positions, *,
              cache: dict | None = None, cache_len: int | None = None):
    """x: (B, S, d).  Without a cache: causal MLA over the sequence;
    returns (out, {"latent" (B, S, r), "k_rope" (B, S, rope)}).  With a
    cache (decode, S = 1): this token's latent and RoPE key are written at
    ``cache_len`` in place and the absorbed decode runs over the first
    ``cache_len + 1``; returns (out, cache)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    r, nope, vdim = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.v_head_dim
    if hasattr(p, "w_dq"):
        ql = rmsnorm(p.q_norm.scale, x @ p.w_dq)
        q = torch.einsum("bsr,rhd->bshd", ql, p.w_uq)
    else:
        q = torch.einsum("bsd,dhe->bshe", x, p.wq)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = x @ p.w_dkv                                          # (B,S,r+rope)
    latent = rmsnorm(p.kv_norm.scale, ckv[..., :r])
    k_rope = ckv[..., r:][:, :, None, :]                       # (B,S,1,rope)
    q_rope, k_rope = position_embed(cfg, q_rope, k_rope, positions)
    if cache is None:
        out = _mla_blockwise(q_nope, q_rope, latent, k_rope, p, cfg)
        new_cache = {"latent": latent, "k_rope": k_rope[:, :, 0, :]}
    else:
        if S != 1:
            raise ValueError("the decode step is single-token")
        cache["latent"][:, cache_len] = latent[:, 0].to(
            cache["latent"].dtype)
        cache["k_rope"][:, cache_len] = k_rope[:, 0, 0].to(
            cache["k_rope"].dtype)
        out = _mla_decode(q_nope, q_rope, cache["latent"], cache["k_rope"],
                          p, cache_len + 1)
        new_cache = cache
    return out.reshape(B, S, H * vdim) @ p.wo, new_cache


def _mla_blockwise(q_nope, q_rope, latent, k_rope, p: MLA, cfg: ModelConfig,
                   stripe=None):
    """Prefill: per KV tile the latent is up-projected to per-head keys
    and values (in the weights' dtype, as the reference's einsums), scores
    q_nope·k_nope + q_rope·k_rope in fp32 over sqrt(nope + rope), causal,
    merged by the online softmax over Q tiles of ``attn_block_q`` and KV
    tiles of ``attn_block_kv``; tiles past the diagonal are skipped (they
    add exactly 0).

    On a rank of a mesh (``ranked.RankModel``) the reference stripes the Q
    tiles over "model" as ``blockwise_attention`` does: ``stripe=(bq, M,
    m)`` says that the queries are stripe m's rows, tile t = l·M + m of bq
    rows at row l·bq (positions ``stripe_positions``), against the whole
    sequence's latent and RoPE key; each of those tiles is a Q tile here.
    A stripe count of 1 is the unstriped call."""
    _count("mla_blockwise:torch")
    B, Sq, H, _ = q_nope.shape
    Skv = latent.shape[1]
    vdim = cfg.v_head_dim
    seg, count, _ = stripe if stripe is not None else (Sq, 1, 0)
    bq = min(cfg.attn_block_q, max(Sq, 16)) if count == 1 else seg
    if count == 1:
        stripe = None
    bkv = min(cfg.attn_block_kv, Skv)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    dev = q_nope.device
    pos = stripe_positions(Sq, stripe, dev)
    last = stripe_positions(Sq, stripe).tolist()       # no sync
    kr = k_rope[:, :, 0, :]
    out = torch.empty((B, Sq, H, vdim), dtype=q_nope.dtype, device=dev)
    tiles = []
    for k0 in range(0, Skv, bkv):
        k1 = min(Skv, k0 + bkv)
        lat = latent[:, k0:k1]
        tiles.append((k0, k1,
                      torch.einsum("btr,rhd->bhtd", lat, p.w_uk).float(),
                      torch.einsum("btr,rhd->bhtd", lat, p.w_uv).float(),
                      kr[:, k0:k1].float()))
    for q0 in range(0, Sq, bq):
        q1 = min(Sq, q0 + bq)
        qn = q_nope[:, q0:q1].float().permute(0, 2, 1, 3)      # (B,H,bq,e)
        qr = q_rope[:, q0:q1].float().permute(0, 2, 1, 3)
        qp = pos[q0:q1, None]
        acc = torch.zeros((B, H, q1 - q0, vdim), dtype=torch.float32,
                          device=dev)
        m_run = torch.full((B, H, q1 - q0), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros_like(m_run)
        for k0, k1, k_nope, v_blk, kr_blk in tiles:
            if k0 > last[q1 - 1]:
                break
            s = (torch.einsum("bhqd,bhtd->bhqt", qn, k_nope)
                 + torch.einsum("bhqd,btd->bhqt", qr, kr_blk)) * scale
            mask = qp >= torch.arange(k0, k1, device=dev)[None, :]
            s = torch.where(mask, s, NEG_INF)
            m = s.amax(dim=-1)
            pr = torch.exp(s - m[..., None])
            l = pr.sum(dim=-1)
            o = torch.einsum("bhqt,bhtd->bhqd", pr, v_blk)
            m_new = torch.maximum(m_run, m)
            a = torch.exp(m_run - m_new)
            b2 = torch.exp(m - m_new)
            acc = acc * a[..., None] + o * b2[..., None]
            l_run = l_run * a + l * b2
            m_run = m_new
        res = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, q0:q1] = res.permute(0, 2, 1, 3).to(q_nope.dtype)
    return out


def _mla_decode(q_nope, q_rope, latent_c, krope_c, p: MLA, cur_len: int):
    """Absorbed decode: attention in latent space, O(S·r) per head."""
    _count("mla_decode:torch")
    scale = 1.0 / math.sqrt(q_nope.shape[-1] + q_rope.shape[-1])
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, p.w_uk)      # (B,1,H,r)
    s = (torch.einsum("bshr,btr->bhst", q_abs.float(), latent_c.float())
         + torch.einsum("bshd,btd->bhst", q_rope.float(),
                        krope_c.float())) * scale
    S = latent_c.shape[1]
    valid = (torch.arange(S, device=s.device) < cur_len)[None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", pr, latent_c.float())
    out = torch.einsum("bshr,rhd->bshd", ctx, p.w_uv.float())
    return out.to(q_nope.dtype)


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
