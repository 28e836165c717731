"""The port's MoE layer as two parts (``moe.plan``, ``moe.experts``),
which the one-device model and a rank of a mesh both call.

``moe_apply`` is ``plan`` then ``experts`` over every expert; it must
stay the arithmetic it was before the split, bit for bit: ``_before``
below is that arithmetic, kept verbatim, and the two are held equal on
reduced llama4-maverick (top-1) and kimi-k2 (top-4) in fp32 and bf16,
the output and every gradient (one thread: the CPU's index backward sums
in thread order otherwise).  The experts run over chunks of their range,
as a rank runs its own, add up to the whole; ``record_routes`` keeps
each call's keep flags (the drop set ``DROPS`` counts) and router
probabilities.
"""
import math

import pytest
import torch
from torch import nn

from repro_torch.configs import get_reduced
from repro_torch.models import moe

ARCHS = ("llama4-maverick-400b-a17b", "kimi-k2-1t-a32b")
B, S = 4, 64
#: the weights scaled up from N(0, 0.02²) so that the router's
#: probabilities spread and the capacity drops assignments
SCALE = 20.0


def _before(p, x, cfg):
    """``moe_apply`` as it was before the split (verbatim)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    top_w, top_e = moe.route(p, x, cfg)
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
    slot = torch.where(keep, se * cap + pos_in_e, E * cap)

    rows = torch.arange(B, device=dev)[:, None]
    vals = x[rows, st] * keep[..., None].to(x.dtype)
    disp = torch.zeros((B, E * cap + 1, d), dtype=x.dtype, device=dev)
    disp[rows, slot] = vals
    h = disp[:, : E * cap].reshape(B, E, cap, d)
    he = h.permute(1, 0, 2, 3).reshape(E, B * cap, d)
    g = nn.functional.silu(torch.bmm(he, p.w_gate))
    u = torch.bmm(he, p.w_up)
    y = torch.bmm(g * u, p.w_down)
    y = y.reshape(E, B, cap, d).permute(1, 0, 2, 3).reshape(B, E * cap, d)

    idx = torch.clamp(slot, max=E * cap - 1)
    wk = (sw * keep.float()).to(y.dtype)
    contrib = y[rows, idx] * wk[..., None]
    out = torch.zeros((B * S, d), dtype=y.dtype, device=dev)
    flat_tok = (st + rows * S).reshape(-1)
    out.index_add_(0, flat_tok, contrib.reshape(B * S * K, d))
    return out.reshape(B, S, d)


def _layer(arch, dtype):
    cfg = get_reduced(arch).scaled(dtype=dtype)
    p = moe.MoE(cfg, "cpu")
    p.reset(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for t in p.parameters():
            t.mul_(SCALE)
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    return cfg, p, x.to(p.w_gate.dtype)


def _run(fn, p, x, cfg):
    """fn's output and the gradients of x and every weight of the sum of
    its squares."""
    for t in p.parameters():
        t.requires_grad_(True)
        t.grad = None
    x = x.clone().requires_grad_(True)
    out = fn(p, x, cfg)
    out.float().square().sum().backward()
    return [out.detach(), x.grad] + [t.grad for t in p.parameters()]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_is_the_arithmetic_before_the_split(arch, dtype):
    """``moe_apply`` (``plan`` + ``experts`` over every expert) gives the
    pre-split arithmetic's output and gradients bit for bit, with
    dropped assignments."""
    cfg, p, x = _layer(arch, dtype)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        moe.reset_drops()
        got = _run(moe.moe_apply, p, x, cfg)
        assert moe.dropped_assignments()[0] > 0
        want = _run(_before, p, x, cfg)
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_chunks_add_up_to_every_expert(arch):
    """``experts`` over three chunks of the expert range, each adding its
    kept assignments into one output, equals every expert at once (fp32:
    a token's top-K contributions then add in another grouping)."""
    cfg, p, x = _layer(arch, "float32")
    with torch.no_grad():
        pl = moe.plan(p, x, cfg)
        out = torch.zeros((B * S, cfg.d_model))
        E = cfg.num_experts
        for c0, c1 in ((0, 3), (3, 5), (5, E)):
            moe.experts(x, pl, p.w_gate[c0:c1], p.w_up[c0:c1],
                        p.w_down[c0:c1], c0, out)
        want = moe.moe_apply(p, x, cfg)
    torch.testing.assert_close(out.reshape(B, S, -1), want, atol=1e-6,
                               rtol=1e-5)
    if cfg.experts_per_token == 1:
        assert torch.equal(out.reshape(B, S, -1), want)


def test_record_routes_keeps_the_drop_set():
    """``record_routes`` keeps each call's top-K experts, keep flags
    whose misses are the drops ``DROPS`` counts, and router
    probabilities (rows summing to 1, the top-K the largest)."""
    cfg, p, x = _layer(ARCHS[1], "float32")
    moe.reset_drops()
    with moe.record_routes() as routes, torch.no_grad():
        moe.moe_apply(p, x, cfg)
        moe.moe_apply(p, x[:2], cfg)
    assert len(routes) == len(routes.kept) == len(routes.probs) == 2
    K = cfg.experts_per_token
    assert routes[0].shape == routes.kept[0].shape == (B, S, K)
    assert routes.probs[0].shape == (B, S, cfg.num_experts)
    dropped = sum(int((~k).sum()) for k in routes.kept)
    assert moe.dropped_assignments() == (dropped, (B + 2) * S * K)
    assert dropped > 0
    torch.testing.assert_close(routes.probs[0].sum(-1),
                               torch.ones((B, S)))
    top = routes.probs[0].topk(K, dim=-1).indices.sort(-1).values
    assert torch.equal(top, routes[0].sort(-1).values)
