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
Inside ``record_routes()`` each call's top-K experts, their keep flags
and the router's probabilities are kept too, once a forward, so a check
can compare two runs' routing and drop sets.

``moe_apply`` is ``plan`` (the router, the capacity, the sort, the slots
and keep flags) and then ``experts`` over every expert: the dispatch of
a range of experts' slots, their products and the weighted combine into
the output.  A rank of a mesh (``models/ranked.py``) calls the same two
on its rows and its own experts' range.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import _param, counting, init_normal, torch_dtype

#: dropped and total assignments since the last ``reset_drops``, as
#: device tensors (no host sync per call)
DROPS: dict = {}
#: each call's top-K experts (B, S, K) on the host, while
#: ``record_routes`` is open
_ROUTES: Routes | None = None


def reset_drops() -> None:
    DROPS.clear()


def dropped_assignments() -> tuple[int, int]:
    """(dropped, total) assignments since the last ``reset_drops``."""
    return (int(DROPS.get("dropped", 0)), int(DROPS.get("total", 0)))


class Routes(list):
    """Each MoE call's top-K experts (a CPU tensor, (B, S, K)) in call
    order; ``kept``: each call's keep flags (bool, (B, S, K), False where
    the assignment was dropped) and ``probs`` its router probabilities
    (fp32, (B, S, E)), in the same order."""

    def __init__(self):
        super().__init__()
        self.kept: list = []
        self.probs: list = []


@contextlib.contextmanager
def record_routes():
    """Yields a ``Routes`` that gets each MoE call's top-K experts, keep
    flags and router probabilities in call order, not again in a remat
    recompute."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, Routes()
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


def router_probs(p: MoE, x):
    """The router's probabilities (B, S, E): a softmax over the experts of
    fp32 logits."""
    return torch.softmax(x.float() @ p.router, dim=-1)


def route(p: MoE, x, cfg: ModelConfig):
    """The router: (top_w (B, S, K) renormalised, top_e (B, S, K))."""
    probs = router_probs(p, x)
    top_w, top_e = top_k(probs, cfg.experts_per_token)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e


class Plan(NamedTuple):
    """Where each of a batch's S·K assignments goes, each row's sorted by
    expert id: ``cap`` slots an expert; ``st``, ``sw``, ``slot``,
    ``keep`` (B, S·K): the token, its renormalised router weight, its
    slot e·cap + place in the (E·cap + 1)-row dispatch buffer (E·cap, the
    overflow row, for a dropped one) and whether it was kept."""
    cap: int
    st: torch.Tensor
    sw: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor


def capacity(S: int, cfg: ModelConfig) -> int:
    """Slots an expert takes a batch row: ceil(S·K/E · the capacity
    factor), at least 4."""
    return max(int(math.ceil(S * cfg.experts_per_token / cfg.num_experts
                             * cfg.moe_capacity_factor)), 4)


def plan(p, x, cfg: ModelConfig) -> Plan:
    """The router (``route``) on x (B, S, d) and the slots of every row's
    assignments; adds the drops to ``DROPS`` and, inside
    ``record_routes``, keeps the top-K experts, keep flags and router
    probabilities (neither again in a remat recompute).  ``p`` needs only
    ``router``."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    top_w, top_e = route(p, x, cfg)
    cap = capacity(S, cfg)
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
    if _ROUTES is not None and counting():
        _ROUTES.append(top_e.cpu())
        _ROUTES.kept.append(torch.empty_like(keep).scatter_(
            1, order, keep).reshape(B, S, K).cpu())
        with torch.no_grad():     # nothing saved for a backward
            _ROUTES.probs.append(router_probs(p, x).cpu())
    return Plan(cap, st, sw, slot, keep)


def experts(x, pl: Plan, w_gate, w_up, w_down, e0: int, out):
    """Experts [e0, e0 + n) on x's rows (B, S, d) by the plan ``pl``,
    their stacked weights ``w_gate``/``w_up`` (n, d, f) and ``w_down``
    (n, f, d): their slots of the dispatch buffer, one batched product an
    expert over the B·cap rows, and each of their kept assignments'
    output, weighted, added to its token's row of ``out`` (B·S, d) in
    place; returns ``out``.  ``moe_apply`` calls it once on every
    expert; a rank on its own experts, a chunk at a time
    (``models/ranked.py``)."""
    B, S, d = x.shape
    n, cap = w_gate.shape[0], pl.cap
    dev = x.device
    local = pl.slot - e0 * cap
    mine = pl.keep & (local >= 0) & (local < n * cap)
    slot = torch.where(mine, local, n * cap)

    # dispatch: each of the range's kept assignments' token into its
    # slot; the others write zeros into the overflow row
    rows = torch.arange(B, device=dev)[:, None]
    vals = x[rows, pl.st] * mine[..., None].to(x.dtype)           # (B,S*K,d)
    disp = torch.zeros((B, n * cap + 1, d), dtype=x.dtype, device=dev)
    disp[rows, slot] = vals
    h = disp[:, : n * cap].reshape(B, n, cap, d)
    # the experts: one batched product per expert over the B·cap rows
    he = h.permute(1, 0, 2, 3).reshape(n, B * cap, d)
    g = nn.functional.silu(torch.bmm(he, w_gate))
    u = torch.bmm(he, w_up)
    y = torch.bmm(g * u, w_down)                                  # (n,B*cap,d)
    y = y.reshape(n, B, cap, d).permute(1, 0, 2, 3).reshape(B, n * cap, d)

    # combine: each assignment's expert output, weighted, added to its
    # token
    idx = torch.clamp(slot, max=n * cap - 1)
    wk = (pl.sw * mine.float()).to(y.dtype)
    contrib = y[rows, idx] * wk[..., None]                        # (B,S*K,d)
    flat_tok = (pl.st + rows * S).reshape(-1)
    return out.index_add_(0, flat_tok, contrib.reshape(-1, d))


def moe_apply(p: MoE, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d): ``plan``, then every expert at once
    (``experts``)."""
    B, S, d = x.shape
    pl = plan(p, x, cfg)
    out = torch.zeros((B * S, d), dtype=x.dtype, device=x.device)
    return experts(x, pl, p.w_gate, p.w_up, p.w_down, 0, out) \
        .reshape(B, S, d)


def moe_aux_stats(p: MoE, x, cfg: ModelConfig) -> dict:
    """Router load statistics (for balance-loss experiments)."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    _, top_e = top_k(probs, cfg.experts_per_token)
    load = torch.bincount(top_e.reshape(-1), minlength=cfg.num_experts)
    return {"mean_prob": probs.mean(0), "load": load}
