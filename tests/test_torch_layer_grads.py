"""The backward of each layer kind against the JAX package's: torch
autograd through the port's layer functions against ``jax.vjp`` of the
reference's, with the reference's own weights and the same numpy inputs
and output cotangent, in float32.

Covered: the masked blockwise attention (a window, a ``kv_mask``, a
``q_offset`` and the logit softcap of 30), local attention past one
window, M-RoPE, MLA's blockwise prefill, the RG-LRU's log-step scan and
its fp32 gate weights, Mamba-2's chunked SSD, and MoE's sort dispatch
at capacity factors that keep and that drop assignments.

Each input and parameter gradient within ``TOL`` in relative Frobenius
norm, |g - g_ref| / |g_ref| (the same fp32 sums in other orders), but
for Mamba-2's ``A_log`` (``A_LOG_TOL``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import mamba2 as RM
from repro.models import moe as RMOE
from repro.models import rglru as RR
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from test_torch_layers import _cfg, _load

torch.set_num_threads(1)

TOL = 1e-5
#: Mamba-2's A_log reads 1.28e-4 at S 96 (1.02e-5 at S 32).  Its gradient
#: per head sums the dA gradients times dt·A over every position, terms
#: whose absolute sum is up to 163 times their sum at S 96 (9 at S 32):
#: the two packages' fp32 dA gradients, a few 1e-7 apart, differ that
#: much more in the sum.  The port's A_log gradient is its own terms'
#: float64 sum within 7.3e-7.
A_LOG_TOL = 1e-3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _twin(ref_fn, port_fn, params, mod, inputs, seed):
    """``jax.vjp`` of ``ref_fn(params, *inputs)`` and autograd of
    ``port_fn(mod, *inputs)`` at one random cotangent: the relative error
    of each input's gradient (by position) and each parameter's (by
    name)."""
    xs = [jnp.asarray(a) for a in inputs]
    out, vjp = jax.vjp(ref_fn, params, *xs)
    dout = np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)
    want_p, *want_x = vjp(jnp.asarray(dout))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    if mod is not None:
        for p in mod.parameters():
            p.requires_grad_(True)
            p.grad = None
    got = port_fn(mod, *ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=TOL, rtol=0)
    got.backward(torch.from_numpy(dout))
    errs = {f"input {i}": _rel(t.grad.numpy(), w)
            for i, (t, w) in enumerate(zip(ts, want_x))}
    if mod is not None:
        flat = dict(jax.tree_util.tree_leaves_with_path(want_p))
        named = {jax.tree_util.keystr(k, simple=True, separator="."): v
                 for k, v in flat.items()}
        for name, p in mod.named_parameters():
            errs[name] = _rel(p.grad.numpy(), named[name])
    print(errs)
    return errs


def _assert_within(errs, tol=None):
    for name, e in errs.items():
        assert e <= (tol or {}).get(name, TOL), (name, e)


MASKED = [
    (150, 150, dict(window=40, softcap=30.0)),
    (96, 160, dict(q_offset=64, window=64, kv_mask="prev", softcap=30.0)),
    (150, 150, dict(kv_mask="random")),
    (100, 130, dict(softcap=30.0, causal=False)),
]


@pytest.mark.parametrize("Sq,Skv,kw", MASKED)
def test_masked_blockwise_backward_matches_reference(Sq, Skv, kw):
    kw = dict(kw)
    softcap = kw.pop("softcap", 0.0)
    causal = kw.pop("causal", True)
    rcfg, cfg = _cfg("starcoder2-3b", attn_logit_softcap=softcap)
    rng = np.random.default_rng(Sq * 1000 + Skv)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    mask = kw.pop("kv_mask", None)
    if mask == "prev":                    # a zero-padded previous window
        mask = np.ones((2, Skv), bool)
        mask[0, :64] = False
    elif mask == "random":
        mask = rng.random((2, Skv)) < 0.6
        mask[:, 0] = True

    def ref(_, q, k, v):
        return RL.blockwise_attention(
            q, k, v, rcfg, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask), **kw)

    def port(_, q, k, v):
        return L.blockwise_attention(
            q, k, v, cfg, causal=causal,
            kv_mask=None if mask is None else torch.from_numpy(mask), **kw)
    L.reset_op_paths()
    _assert_within(_twin(ref, port, {}, None, [q, k, v], 1))
    assert dict(L.OP_PATHS) == {"masked_blockwise:torch": 1}


def test_local_attention_backward_matches_reference():
    """200 positions over windows of 64: three folds and a ragged one."""
    rcfg, cfg = _cfg("recurrentgemma-2b")
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 200, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 200, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, 200, 1, 16)).astype(np.float32)
    _assert_within(_twin(
        lambda _, *a: RL._local_attention(*a, rcfg),
        lambda _, *a: L.local_attention(*a, cfg), {}, None, [q, k, v], 3))


def test_mrope_backward_matches_reference():
    sections = (2, 3, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 40)).astype(np.int32)
    _assert_within(_twin(
        lambda _, x: RL.apply_mrope(x, jnp.asarray(pos), 1e6, sections),
        lambda _, x: L.apply_mrope(x, torch.from_numpy(pos), 1e6, sections),
        {}, None, [x], 5))


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_backward_matches_reference(q_lora):
    rcfg, cfg = _cfg("minicpm3-4b", **({} if q_lora else
                                       dict(q_lora_rank=0)))
    params = RL.init_mla(jax.random.PRNGKey(3), rcfg)
    mod = _load(L.MLA(cfg, "cpu"), jax.tree.map(np.asarray, params))
    x = np.random.default_rng(6).standard_normal(
        (2, 100, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100), (2, 100)).astype(np.int32)
    _assert_within(_twin(
        lambda p, x: RL.mla_apply(p, x, rcfg, jnp.asarray(pos))[0],
        lambda m, x: L.mla_apply(m, x, cfg,
                                 torch.from_numpy(pos).long())[0],
        params, mod, [x], 7))


def test_rglru_backward_matches_reference():
    """300 positions: nine doubling passes of the log-step scan."""
    rcfg, cfg = _cfg("recurrentgemma-2b")
    params = RR.init_rglru(jax.random.PRNGKey(4), rcfg)
    mod = _load(R.RGLRU(cfg, "cpu"), jax.tree.map(np.asarray, params))
    x = np.random.default_rng(8).standard_normal(
        (2, 300, cfg.d_model)).astype(np.float32)
    _assert_within(_twin(lambda p, x: RR.rglru_forward(p, x, rcfg),
                         lambda m, x: R.rglru_forward(m, x, cfg),
                         params, mod, [x], 9))


@pytest.mark.parametrize("S", [96, 32])
def test_mamba2_backward_matches_reference(S):
    """Three SSD chunks of 32, and one."""
    rcfg, cfg = _cfg("mamba2-370m")
    params = RM.init_mamba2(jax.random.PRNGKey(5), rcfg)
    mod = _load(M.Mamba2(cfg, "cpu"), jax.tree.map(np.asarray, params))
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    _assert_within(_twin(lambda p, x: RM.mamba2_forward(p, x, rcfg),
                         lambda m, x: M.mamba2_forward(m, x, cfg),
                         params, mod, [x], 10), {"A_log": A_LOG_TOL})


@pytest.mark.parametrize("arch,factor", [
    ("llama4-maverick-400b-a17b", 1.25), ("kimi-k2-1t-a32b", 1.25),
    ("kimi-k2-1t-a32b", 0.3), ("llama4-maverick-400b-a17b", 0.2)])
def test_moe_backward_matches_reference(arch, factor):
    """The sort dispatch under autograd, at a capacity that keeps every
    assignment and at one that drops some (the drop set itself:
    ``test_torch_layers.py``).  llama4's router gradient is zero in exact
    arithmetic (top-1: the renormalised weight is 1), so it is held
    against the expert weights' scale instead."""
    rcfg, cfg = _cfg(arch, moe_capacity_factor=factor)
    params = RMOE.init_moe(jax.random.PRNGKey(6), rcfg)
    mod = _load(MOE.MoE(cfg, "cpu"), jax.tree.map(np.asarray, params))
    x = np.random.default_rng(11).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    MOE.reset_drops()
    errs = _twin(lambda p, x: RMOE.moe_apply(p, x, rcfg),
                 lambda m, x: MOE.moe_apply(m, x, cfg), params, mod, [x], 12)
    if factor < 1:
        assert MOE.dropped_assignments()[0] > 0
    if cfg.experts_per_token == 1:
        router = mod.router.grad
        assert float(router.norm()) <= 1e-6 * float(mod.w_down.grad.norm())
        del errs["router"]
    _assert_within(errs)
