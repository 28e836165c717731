"""Mixture-of-Experts layer (Llama-4 top-1 / Kimi-K2 top-8).

The port of the JAX package's ``models/moe.py`` (layer kind "M").
Dispatch is sort-based with a capacity bound, per batch element: each
row's S·K assignments are sorted by expert id (a stable sort, as
``jnp.argsort``), each takes a slot in its expert's (E, cap, d) buffer
unless the expert is full (then it is dropped: it goes to the overflow
row E·cap), the experts run as one grouped product, and the results are
added back weighted by the renormalised router probabilities
(``index_add_``).  The top K experts come from a stable descending sort
of the router probabilities, so a tie goes to the lower expert index, as
in ``jax.lax.top_k``.  Expert weights are stacked (E, d, f).

``DROPS`` adds up, on the device, the assignments each call drops
(``dropped_assignments()`` reads it), so a caller can show that a run
dropped none; a remat recompute adds nothing (``layers.recomputing``).
Inside ``record_routes()`` each call's top-K experts are kept too, once
a forward, so a check can compare two runs' routing.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from .config import ModelConfig
from .layers import _param, counting, init_normal, torch_dtype

#: dropped and total assignments since the last ``reset_drops``, as
#: device tensors (no host sync per call)
DROPS: dict = {}
#: each call's top-K experts (B, S, K) on the host, while
#: ``record_routes`` is open
_ROUTES: list | None = None


def reset_drops() -> None:
    DROPS.clear()


def dropped_assignments() -> tuple[int, int]:
    """(dropped, total) assignments since the last ``reset_drops``."""
    return (int(DROPS.get("dropped", 0)), int(DROPS.get("total", 0)))


@contextlib.contextmanager
def record_routes():
    """Yields a list that gets each MoE call's top-K experts (a CPU
    tensor, (B, S, K)) in call order, not again in a remat recompute."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        dt = torch_dtype(cfg.dtype)
        self.router = _param((d, E), torch.float32, device)
        self.w_gate = _param((E, d, f), dt, device)
        self.w_up = _param((E, d, f), dt, device)
        self.w_down = _param((E, f, d), dt, device)

    def reset(self, generator: torch.Generator) -> None:
        for p in (self.router, self.w_gate, self.w_up, self.w_down):
            init_normal(p, generator)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, a tie to
    the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: MoE, x, cfg: ModelConfig):
    """The router: (top_w (B, S, K) renormalised, top_e (B, S, K))."""
    logits = x.float() @ p.router                                 # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, cfg.experts_per_token)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e


def moe_apply(p: MoE, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    top_w, top_e = route(p, x, cfg)
    if _ROUTES is not None and counting():
        _ROUTES.append(top_e.cpu())
    cap = max(int(math.ceil(S * K / E * cfg.moe_capacity_factor)), 4)
    dev = x.device

    flat_e = top_e.reshape(B, S * K)
    flat_w = top_w.reshape(B, S * K)
    tok = (torch.arange(S * K, device=dev) // K)[None, :].expand(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    st = torch.gather(tok, 1, order)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_in_e = torch.arange(S * K, device=dev)[None, :] - torch.gather(
        starts, 1, se)
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, E * cap)       # (B, S*K)
    if counting() and dev.type != "meta":     # a dry run has no values
        DROPS["dropped"] = DROPS.get("dropped", 0) + (~keep).sum()
        DROPS["total"] = DROPS.get("total", 0) + B * S * K

    # dispatch: each kept assignment's token into its slot; the dropped
    # ones write zeros into the overflow row
    rows = torch.arange(B, device=dev)[:, None]
    vals = x[rows, st] * keep[..., None].to(x.dtype)              # (B,S*K,d)
    disp = torch.zeros((B, E * cap + 1, d), dtype=x.dtype, device=dev)
    disp[rows, slot] = vals
    h = disp[:, : E * cap].reshape(B, E, cap, d)
    # the experts: one batched product per expert over the B·cap rows
    he = h.permute(1, 0, 2, 3).reshape(E, B * cap, d)
    g = nn.functional.silu(torch.bmm(he, p.w_gate))
    u = torch.bmm(he, p.w_up)
    y = torch.bmm(g * u, p.w_down)                                # (E,B*cap,d)
    y = y.reshape(E, B, cap, d).permute(1, 0, 2, 3).reshape(B, E * cap, d)

    # combine: each assignment's expert output, weighted, added to its
    # token
    idx = torch.clamp(slot, max=E * cap - 1)
    wk = (sw * keep.float()).to(y.dtype)
    contrib = y[rows, idx] * wk[..., None]                        # (B,S*K,d)
    out = torch.zeros((B * S, d), dtype=y.dtype, device=dev)
    flat_tok = (st + rows * S).reshape(-1)
    out.index_add_(0, flat_tok, contrib.reshape(B * S * K, d))
    return out.reshape(B, S, d)


def moe_aux_stats(p: MoE, x, cfg: ModelConfig) -> dict:
    """Router load statistics (for balance-loss experiments)."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    _, top_e = top_k(probs, cfg.experts_per_token)
    load = torch.bincount(top_e.reshape(-1), minlength=cfg.num_experts)
    return {"mean_prob": probs.mean(0), "load": load}
