"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of the JAX package's ``models/rglru.py`` (layer kind "R"): a
linear x branch and a GELU gate branch, a short causal depthwise conv on
the x branch, then the Real-Gated LRU

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference's forward runs ``jax.lax.associative_scan`` over the
(a, b) pairs; here it is a log-step (Hillis-Steele) scan of the same
combine, ceil(log2 S) passes over (B, S, d) in fp32, which sums in
another order (the twin tests state their tolerance).  Decode is an O(1)
state update.  ``wa``, ``wi``, the conv and the gate vectors are fp32, as
the reference makes them.
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import _param, init_normal, torch_dtype


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        dt = torch_dtype(cfg.dtype)
        f32 = torch.float32
        self.w_x = _param((d, d), dt, device)
        self.w_gate = _param((d, d), dt, device)
        self.conv_w = _param((cfg.rglru_conv, d), f32, device)
        self.conv_b = _param((d,), f32, device)
        self.wa = _param((d, d), f32, device)
        self.ba = _param((d,), f32, device)
        self.wi = _param((d, d), f32, device)
        self.bi = _param((d,), f32, device)
        self.lam = _param((d,), f32, device)
        self.w_out = _param((d, d), dt, device)

    def reset(self, generator: torch.Generator) -> None:
        init_normal(self.w_x, generator)
        init_normal(self.w_gate, generator)
        init_normal(self.conv_w, generator, scale=0.1)
        init_normal(self.wa, generator, scale=0.01)
        init_normal(self.wi, generator, scale=0.01)
        init_normal(self.w_out, generator)
        with torch.no_grad():
            for p in (self.conv_b, self.ba, self.bi):
                p.zero_()
            self.lam.copy_(torch.linspace(0.9, 5.0, self.lam.shape[0],
                                          dtype=torch.float32))


def _conv(x, w, b, state=None):
    """Causal depthwise conv along the sequence; ``state`` (B, K-1, d)
    holds the previous inputs in decode.  Returns (out in x's dtype, the
    new state or None)."""
    K = w.shape[0]
    if state is None:
        pad = nn.functional.pad(x, (0, 0, K - 1, 0))
        new_state = None
    else:
        pad = torch.cat([state, x.to(state.dtype)], dim=1)
        new_state = pad[:, -(K - 1):]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + pad[:, i: i + x.shape[1], :].float() * w[i]
    return (out + b).to(x.dtype), new_state


def _lru_gates(p: RGLRU, xb, cfg: ModelConfig, gates_in=None):
    """(a, gated input) of the channels of ``xb``; the gate products read
    ``gates_in`` (default ``xb``): on a rank of a mesh, the whole
    width's xb, while ``xb`` and the gate columns are the rank's
    channels."""
    xf = xb.float()
    xg = xf if gates_in is None else gates_in.float()
    r = torch.sigmoid(xg @ p.wa + p.ba)
    i = torch.sigmoid(xg @ p.wi + p.bi)
    log_a = -cfg.rglru_c * nn.functional.softplus(p.lam) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated_in


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1: the inclusive
    scan of the combine (a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2), by
    doubling offsets."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_forward(p: RGLRU, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d)."""
    xb = x @ p.w_x
    gate = nn.functional.gelu((x @ p.w_gate).float(), approximate="tanh")
    xb, _ = _conv(xb, p.conv_w, p.conv_b)
    a, gin = _lru_gates(p, xb, cfg)
    h = linear_scan(a, gin)
    y = (h * gate).to(x.dtype)
    return y @ p.w_out


def rglru_init_cache(cfg: ModelConfig, batch: int, device,
                     dtype=torch.float32) -> dict:
    return {"conv": torch.zeros((batch, cfg.rglru_conv - 1, cfg.d_model),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=device)}


def rglru_step(p: RGLRU, x, cfg: ModelConfig, cache: dict):
    """x: (B, 1, d); the O(1) state update, written into ``cache`` in
    place.  Returns (out, cache)."""
    xb = x @ p.w_x
    gate = nn.functional.gelu((x @ p.w_gate).float(), approximate="tanh")
    xb, new_conv = _conv(xb, p.conv_w, p.conv_b, state=cache["conv"])
    a, gin = _lru_gates(p, xb, cfg)
    h = cache["h"] * a[:, 0] + gin[:, 0]
    cache["conv"].copy_(new_conv)
    cache["h"].copy_(h)
    y = (h[:, None, :] * gate).to(x.dtype)
    return y @ p.w_out, cache
