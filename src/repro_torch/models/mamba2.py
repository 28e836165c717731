"""Mamba-2 block: SSD (state-space duality) with a chunked scan.

The port of the JAX package's ``models/mamba2.py`` (layer kind "S"),
arXiv:2405.21060: the sequence splits into chunks of ``ssm_chunk``
steps; the intra-chunk term is quadratic and attention-like, and the
(H, P, N) chunk states are carried through a linear recurrence across
chunks, so peak memory is O(B·H·Q² + S/Q·B·H·P·N).  As in the reference
the sequence length must be a multiple of the chunk (or shorter than
one).  Decode keeps (conv state (B, K-1, conv_dim), ssm state (B, H, P,
N)) in fp32 and steps in O(1), written in place.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .config import ModelConfig
from .layers import RMSNorm, _param, init_normal, rmsnorm, torch_dtype


def _dims(cfg: ModelConfig):
    return (cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.ssm_groups)


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        di, H, P, N, G = _dims(cfg)
        conv_dim = di + 2 * G * N
        dt = torch_dtype(cfg.dtype)
        f32 = torch.float32
        # order: [z (di), x (di), B (G*N), C (G*N), dt (H)]
        self.in_proj = _param((d, 2 * di + 2 * G * N + H), dt, device)
        self.conv_w = _param((cfg.ssm_conv, conv_dim), f32, device)
        self.conv_b = _param((conv_dim,), f32, device)
        self.dt_bias = _param((H,), f32, device)
        self.A_log = _param((H,), f32, device)
        self.D = _param((H,), f32, device)
        self.out_norm = RMSNorm(di, device)
        self.out_proj = _param((di, d), dt, device)

    def reset(self, generator: torch.Generator) -> None:
        init_normal(self.in_proj, generator)
        init_normal(self.conv_w, generator, scale=0.1)
        init_normal(self.out_proj, generator)
        self.out_norm.reset()
        H = self.A_log.shape[0]
        with torch.no_grad():
            self.conv_b.zero_()
            self.dt_bias.zero_()
            self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H,
                                                      dtype=torch.float32)))
            self.D.fill_(1.0)


def _split_proj(proj, cfg: ModelConfig):
    di, H, P, N, G = _dims(cfg)
    return proj[..., :di], proj[..., di: 2 * di + 2 * G * N], proj[..., -H:]


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along the sequence: xBC (B, S, D), w (K, D),
    then SiLU."""
    K = w.shape[0]
    pad = nn.functional.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):
        out = out + pad[:, i: i + xBC.shape[1], :].float() * w[i]
    return nn.functional.silu(out + b).to(xBC.dtype)


def segsum(a_chunk: torch.Tensor) -> torch.Tensor:
    """Log-space cumulative products L[i, j] = sum_{j < s <= i} a_s over
    the last axis, (..., Q, Q), -inf above the diagonal."""
    Q = a_chunk.shape[-1]
    cs = torch.cumsum(a_chunk, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=a_chunk.device))
    return torch.where(mask, diff, -math.inf)


def ssd(xs, Bm, Cm, dt, A, Q: int):
    """The SSD chunked scan: xs (B, S, H, P), Bm and Cm (B, S, H, N), dt
    (B, S, H) after the softplus, A (H,) the (negative) decay rates, Q
    the chunk -> y (B, S, H, P) in fp32, the intra-chunk term plus the
    carried states' (without the skip term D)."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    nc = S // Q
    dA = dt * A                                                  # log decay

    def chunk(t):
        return t.reshape(B, nc, Q, *t.shape[2:])

    xs_c, B_c, C_c, dt_c = map(chunk, (xs, Bm, Cm, dt))
    dAh = chunk(dA).permute(0, 1, 3, 2)                          # (B,nc,H,Q)

    # intra-chunk (diagonal) term
    L = torch.exp(segsum(dAh))                                   # (B,nc,H,Q,Q)
    scores = torch.einsum("bchqn,bchkn->bchqk", C_c.permute(0, 1, 3, 2, 4),
                          B_c.permute(0, 1, 3, 2, 4))
    M = scores * L
    xdt = xs_c * dt_c[..., None]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xdt)

    # chunk states: decay from step k (exclusive) to the chunk's end
    decay_end = torch.exp(torch.flip(torch.cumsum(torch.flip(dAh, [-1]),
                                                  dim=-1), [-1]) - dAh)
    states = torch.einsum("bchk,bckhn,bckhp->bchpn", decay_end,
                          B_c.float(), xdt)
    chunk_decay = torch.exp(torch.sum(dAh, dim=-1))               # (B,nc,H)
    carry = torch.zeros((B, H, P, N), dtype=torch.float32, device=xs.device)
    prev = []
    for c in range(nc):                      # the state entering chunk c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (B,nc,H,P,N)

    decay_in = torch.exp(torch.cumsum(dAh, dim=-1))              # (B,nc,H,Q)
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", C_c.float(),
                         prev_states, decay_in)
    return (y_diag + y_off).reshape(B, S, H, P)


def mamba2_forward(p: Mamba2, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d); the full-sequence SSD."""
    B, S, _ = x.shape
    di, H, P, N, G = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by ssd chunk {Q}")
    proj = x @ p.in_proj
    z, xBC, dt = _split_proj(proj, cfg)
    xBC = _causal_conv(xBC, p.conv_w, p.conv_b)
    xs = xBC[..., :di].reshape(B, S, H, P)
    rep = H // G
    Bm = xBC[..., di: di + G * N].reshape(B, S, G, N) \
        .repeat_interleave(rep, dim=2)                          # (B,S,H,N)
    Cm = xBC[..., di + G * N:].reshape(B, S, G, N) \
        .repeat_interleave(rep, dim=2)
    dt = nn.functional.softplus(dt.float() + p.dt_bias)         # (B,S,H)
    y = ssd(xs, Bm, Cm, dt, -torch.exp(p.A_log), Q)
    y = y + xs.float() * p.D[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(p.out_norm.scale,
                (y * nn.functional.silu(z.float())).to(x.dtype))
    return y @ p.out_proj


def mamba2_init_cache(cfg: ModelConfig, batch: int, device,
                      dtype=torch.float32) -> dict:
    di, H, P, N, G = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * G * N),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device)}


def ssm_step(ssm, xs, Bm, Cm, dt, A, D):
    """One token of the SSM: the state ``ssm`` (B, H, P, N) decayed and
    updated by xs (B, H, P), Bm (B, H, N) and dt (B, H) after the
    softplus -> (y (B, H, P) in fp32 with the skip term D, the new
    state)."""
    da = torch.exp(dt * A)
    upd = torch.einsum("bhn,bhp,bh->bhpn", Bm.float(), xs.float(), dt)
    ssm = ssm * da[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Cm.float(), ssm)
    return y + xs.float() * D[None, :, None], ssm


def mamba2_step(p: Mamba2, x, cfg: ModelConfig, cache: dict):
    """One token: x (B, 1, d) -> (B, 1, d); the state update is written
    into ``cache`` in place.  Returns (out, cache)."""
    B = x.shape[0]
    di, H, P, N, G = _dims(cfg)
    proj = x[:, 0] @ p.in_proj
    z, xBC, dt = _split_proj(proj, cfg)
    conv_in = torch.cat([cache["conv"], xBC[:, None, :].to(
        cache["conv"].dtype)], dim=1)
    acc = torch.einsum("bkd,kd->bd", conv_in.float(), p.conv_w)
    xBC = nn.functional.silu(acc + p.conv_b).to(x.dtype)
    xs = xBC[..., :di].reshape(B, H, P)
    Bm = xBC[..., di: di + G * N].reshape(B, G, N).repeat_interleave(
        H // G, dim=1)
    Cm = xBC[..., di + G * N:].reshape(B, G, N).repeat_interleave(
        H // G, dim=1)
    dt = nn.functional.softplus(dt.float() + p.dt_bias)         # (B,H)
    y, ssm = ssm_step(cache["ssm"], xs, Bm, Cm, dt, -torch.exp(p.A_log), p.D)
    y = y.reshape(B, di)
    y = rmsnorm(p.out_norm.scale,
                (y * nn.functional.silu(z.float())).to(x.dtype))
    cache["conv"].copy_(conv_in[:, 1:])
    cache["ssm"].copy_(ssm)
    return (y @ p.out_proj)[:, None, :], cache
