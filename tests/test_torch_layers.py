"""The port's layer modules against the JAX package's, one function at a
time: M-RoPE, the masked blockwise attention (window, ``kv_mask``,
``q_offset``, softcap), local attention, the int8 KV cache, MLA, RG-LRU,
Mamba-2, MoE, and ``configs/shapes.py``.

Inputs come from numpy seeds; weights are the reference's own (its
``init_*`` from a ``PRNGKey``), copied into the port's modules.
Tolerances: fp32 within 1e-5 absolute for attention, M-RoPE and MLA
(the same fp32 sums in other orders), 1e-5 for RG-LRU (the port's
log-step scan multiplies the decays in another order than
``jax.lax.associative_scan``) and 1e-5 for Mamba-2; int8 bytes, the MoE
drop set and the routing exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_reduced as ref_get_reduced
from repro.configs import shapes as ref_shapes
from repro.models import layers as RL
from repro.models import mamba2 as RM
from repro.models import moe as RMOE
from repro.models import rglru as RR
from repro_torch.configs import get_reduced
from repro_torch.configs import shapes
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R

torch.set_num_threads(1)

ATOL = 1e-5


def _rng(*key):
    return np.random.default_rng(abs(hash(repr(key))) % (2 ** 32))


def _load(module, params: dict):
    """Copy a reference parameter dict (nested, numpy leaves) into a port
    module by name."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + ".")
            else:
                flat[name] = v
    walk(params, "")
    own = dict(module.named_parameters())
    assert set(own) == set(flat), (sorted(own), sorted(flat))
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(flat[name])
            if arr.dtype.name == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(arr.copy())
            p.copy_(t)
    return module


def _cfg(arch, **over):
    over.setdefault("dtype", "float32")
    return ref_get_reduced(arch).scaled(**over), get_reduced(arch).scaled(
        **over)


# ---------------------------------------------------------------------------
# positions and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_apply_mrope_matches_reference(sections):
    hd = 2 * sum(sections)
    rng = _rng("mrope", sections)
    x = rng.standard_normal((2, 40, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 40)).astype(np.int32)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


#: (Sq, Skv, kwargs): windows, offsets, masks and the softcap, alone and
#: together, over several 32-row Q and 64-row KV tiles
MASKED = [
    (150, 150, dict(window=40)),
    (150, 150, dict(window=40, softcap=20.0)),
    (96, 160, dict(q_offset=64)),
    (96, 160, dict(q_offset=64, window=64, kv_mask="prev")),
    (150, 150, dict(kv_mask="random")),
    (150, 150, dict(softcap=5.0)),
    (100, 130, dict(softcap=30.0, causal=False)),
]


@pytest.mark.parametrize("Sq,Skv,kw", MASKED)
def test_blockwise_attention_masks_match_reference(Sq, Skv, kw):
    kw = dict(kw)
    softcap = kw.pop("softcap", 0.0)
    causal = kw.pop("causal", True)
    rcfg, cfg = _cfg("starcoder2-3b", attn_logit_softcap=softcap)
    rng = _rng("masked", Sq, Skv, repr(kw), softcap)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    if "kv_mask" in kw:
        if kw["kv_mask"] == "prev":       # a zero-padded previous window
            mask = np.ones((2, Skv), bool)
            mask[0, :64] = False
        else:
            mask = rng.random((2, Skv)) < 0.6
            mask[:, 0] = True
        kw["kv_mask"] = mask
    want = RL.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), rcfg, causal=causal,
        **{n: jnp.asarray(x) if n == "kv_mask" else x for n, x in kw.items()})
    L.reset_op_paths()
    got = L.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), cfg, causal=causal,
        **{n: torch.from_numpy(x) if n == "kv_mask" else x
           for n, x in kw.items()})
    assert dict(L.OP_PATHS) == {"masked_blockwise:torch": 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_unmasked_causal_attention_routes_to_kernel_11():
    _, cfg = _cfg("starcoder2-3b")
    q = torch.zeros(1, 64, 4, 16)
    k = torch.zeros(1, 64, 2, 16)
    L.reset_op_paths()
    L.blockwise_attention(q, k, k, cfg)
    assert dict(L.OP_PATHS) == {"flash_attention:torch-cpu": 1}


@pytest.mark.parametrize("S", [200, 64, 40])
def test_local_attention_matches_reference(S):
    """S not a multiple of the window (200 over 64), one window, less."""
    rcfg, cfg = _cfg("recurrentgemma-2b")
    rng = _rng("local", S)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
    want = RL._local_attention(*(jnp.asarray(a) for a in (q, k, v)), rcfg)
    got = L.local_attention(*(torch.from_numpy(a) for a in (q, k, v)), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bytes_equal_reference(dtype):
    rng = _rng("q8", dtype)
    x = rng.standard_normal((3, 50, 2, 16)).astype(np.float32) * \
        rng.uniform(0.01, 10, (3, 50, 2, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero vector: floor 1e-6
    x[1, 1, 1, :4] = [0.5, -0.5, 1.5, 2.5]   # halves: round to even
    xj = jnp.asarray(x).astype(dtype)
    q8, scale = RL._quantize_kv(xj)
    got8, gscale = L.quantize_kv(torch.from_numpy(
        np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got8.numpy(), np.asarray(q8))
    np.testing.assert_array_equal(gscale.numpy(), np.asarray(scale))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_attention_q8_matches_reference(softcap):
    rng = _rng("dq8", softcap)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k8 = rng.integers(-127, 128, (2, 40, 2, 16)).astype(np.int8)
    v8 = rng.integers(-127, 128, (2, 40, 2, 16)).astype(np.int8)
    ks = rng.uniform(1e-3, 0.05, (2, 40, 2)).astype(np.float32)
    vs = rng.uniform(1e-3, 0.05, (2, 40, 2)).astype(np.float32)
    want = RL.decode_attention_q8(*(jnp.asarray(a) for a in
                                    (q, k8, ks, v8, vs)), 29, softcap)
    got = L.decode_attention_q8(*(torch.from_numpy(a) for a in
                                  (q, k8, ks, v8, vs)), 29, softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_attention_softcap_matches_reference(softcap):
    rng = _rng("dec", softcap)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 40, 2, 16)).astype(np.float32) * 3
    vc = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    want = RL.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc)), 33,
                               softcap)
    got = L.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                             33, softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_prefill_and_decode_match_reference(q_lora):
    over = {} if q_lora else dict(q_lora_rank=0)
    rcfg, cfg = _cfg("minicpm3-4b", **over)
    params = jax.tree.map(np.asarray,
                          RL.init_mla(jax.random.PRNGKey(3), rcfg))
    mod = _load(L.MLA(cfg, "cpu"), params)
    rng = _rng("mla", q_lora)
    S = 100
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    want, wcache = RL.mla_apply(params, jnp.asarray(x), rcfg,
                                jnp.asarray(pos))
    got, gcache = L.mla_apply(mod, torch.from_numpy(x), cfg,
                              torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(gcache[name].numpy(),
                                   np.asarray(wcache[name]), atol=ATOL)
    # decode: the prefill's first 60 positions in the cache, then 10 steps
    cache = {n: torch.zeros((2, 80, t.shape[-1])) for n, t in gcache.items()}
    rcache = {n: jnp.zeros((2, 80, t.shape[-1])) for n, t in gcache.items()}
    for n in cache:
        cache[n][:, :60] = gcache[n][:, :60]
        rcache[n] = rcache[n].at[:, :60].set(wcache[n][:, :60])
    for t in range(60, 70):
        xt = x[:, t:t + 1]
        p = np.full((2, 1), t, np.int32)
        want, rcache = RL.mla_apply(params, jnp.asarray(xt), rcfg,
                                    jnp.asarray(p), cache=rcache,
                                    cache_len=t)
        got, cache = L.mla_apply(mod, torch.from_numpy(xt), cfg,
                                 torch.from_numpy(p).long(), cache=cache,
                                 cache_len=t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"position {t}")


# ---------------------------------------------------------------------------
# RG-LRU and Mamba-2
# ---------------------------------------------------------------------------

def test_rglru_forward_and_step_match_reference():
    rcfg, cfg = _cfg("recurrentgemma-2b")
    params = jax.tree.map(np.asarray,
                          RR.init_rglru(jax.random.PRNGKey(4), rcfg))
    mod = _load(R.RGLRU(cfg, "cpu"), params)
    rng = _rng("rglru")
    x = rng.standard_normal((2, 300, cfg.d_model)).astype(np.float32)
    want = RR.rglru_forward(params, jnp.asarray(x), rcfg)
    got = R.rglru_forward(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    cache = R.rglru_init_cache(cfg, 2, "cpu")
    rcache = RR.rglru_init_cache(rcfg, 2)
    for t in range(12):
        xt = x[:, t:t + 1]
        want, rcache = RR.rglru_step(params, jnp.asarray(xt), rcfg, rcache)
        got, cache = R.rglru_step(mod, torch.from_numpy(xt), cfg, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
        np.testing.assert_allclose(cache["h"].numpy(),
                                   np.asarray(rcache["h"]), atol=ATOL)


def test_linear_scan_is_the_recurrence():
    rng = _rng("scan")
    a = torch.from_numpy(rng.uniform(0, 1, (2, 77, 5)).astype(np.float64))
    b = torch.from_numpy(rng.standard_normal((2, 77, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(77):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(R.linear_scan(a, b), torch.stack(want, 1),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("S", [96, 20])
def test_mamba2_forward_and_step_match_reference(S):
    """Three chunks of 32, and one shorter than a chunk."""
    rcfg, cfg = _cfg("mamba2-370m")
    params = jax.tree.map(np.asarray,
                          RM.init_mamba2(jax.random.PRNGKey(5), rcfg))
    mod = _load(M.Mamba2(cfg, "cpu"), params)
    rng = _rng("mamba", S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want = RM.mamba2_forward(params, jnp.asarray(x), rcfg)
    got = M.mamba2_forward(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    cache = M.mamba2_init_cache(cfg, 2, "cpu")
    rcache = RM.mamba2_init_cache(rcfg, 2)
    for t in range(10):
        xt = x[:, t:t + 1]
        want, rcache = RM.mamba2_step(params, jnp.asarray(xt), rcfg, rcache)
        got, cache = M.mamba2_step(mod, torch.from_numpy(xt), cfg, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
        np.testing.assert_allclose(cache["ssm"].numpy(),
                                   np.asarray(rcache["ssm"]), atol=ATOL)


def test_mamba2_refuses_a_ragged_sequence():
    _, cfg = _cfg("mamba2-370m")
    mod = M.Mamba2(cfg, "cpu")
    mod.reset(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="chunk"):
        M.mamba2_forward(mod, torch.zeros(1, 40, cfg.d_model), cfg)


def test_segsum_matches_reference():
    a = _rng("segsum").standard_normal((3, 2, 9)).astype(np.float32)
    np.testing.assert_allclose(M.segsum(torch.from_numpy(a)).numpy(),
                               np.asarray(RM._segsum(jnp.asarray(a))),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_twins(arch, **over):
    rcfg, cfg = _cfg(arch, **over)
    params = jax.tree.map(np.asarray, RMOE.init_moe(jax.random.PRNGKey(6),
                                                    rcfg))
    return rcfg, cfg, params, _load(MOE.MoE(cfg, "cpu"), params)


def _ref_kept(params, x, cfg):
    """The reference's kept (token, expert) assignments, recomputed from
    its own router and sort as ``moe_apply`` does."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"], -1)
    _, top_e = jax.lax.top_k(probs, K)
    cap = max(int(np.ceil(S * K / E * cfg.moe_capacity_factor)), 4)
    flat_e = np.asarray(top_e).reshape(B, S * K)
    out = []
    for b in range(B):
        order = np.argsort(flat_e[b], kind="stable")
        seen = np.zeros(E, int)
        kept = set()
        for i in order:
            e = flat_e[b, i]
            if seen[e] < cap:
                kept.add((i // K, int(e)))
            seen[e] += 1
        out.append(kept)
    return np.asarray(top_e), out


@pytest.mark.parametrize("arch,factor", [
    ("llama4-maverick-400b-a17b", 1.25), ("kimi-k2-1t-a32b", 1.25),
    ("kimi-k2-1t-a32b", 0.3), ("llama4-maverick-400b-a17b", 0.2)])
def test_moe_apply_matches_reference(arch, factor):
    """fp32 output within 1e-5; the routing and, at a capacity factor
    small enough to drop assignments, the dropped set equal."""
    rcfg, cfg, params, mod = _moe_twins(arch, moe_capacity_factor=factor)
    rng = _rng("moe", arch, factor)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want = RMOE.moe_apply(params, jnp.asarray(x), rcfg)
    MOE.reset_drops()
    got = MOE.moe_apply(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    ref_e, ref_kept = _ref_kept(params, x, rcfg)
    _, top_e = MOE.route(mod, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(top_e.numpy(), ref_e)
    dropped, total = MOE.dropped_assignments()
    assert total == 2 * 64 * cfg.experts_per_token
    assert dropped == total - sum(len(k) for k in ref_kept)
    if factor < 1:
        assert dropped > 0


def test_moe_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = MOE.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_aux_stats_match_reference():
    rcfg, cfg, params, mod = _moe_twins("kimi-k2-1t-a32b")
    x = _rng("aux").standard_normal((2, 30, cfg.d_model)).astype(np.float32)
    want = RMOE.moe_aux_stats(params, jnp.asarray(x), rcfg)
    got = MOE.moe_aux_stats(mod, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(got["load"].numpy(),
                                  np.asarray(want["load"]))
    np.testing.assert_allclose(got["mean_prob"].numpy(),
                               np.asarray(want["mean_prob"]), atol=1e-7)


# ---------------------------------------------------------------------------
# configs/shapes.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(ref_shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_reference(arch, shape):
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rs, ps = ref_shapes.SHAPES[shape], shapes.SHAPES[shape]
    assert (ps.name, ps.kind, ps.seq_len, ps.global_batch,
            ps.subquadratic_only) == (rs.name, rs.kind, rs.seq_len,
                                      rs.global_batch, rs.subquadratic_only)
    assert shapes.shape_applicable(cfg, ps) == \
        ref_shapes.shape_applicable(rcfg, rs)
    want = ref_shapes.input_specs(rcfg, rs)
    got = shapes.input_specs(cfg, ps)
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert spec.shape == tuple(want[name].shape), name
        assert str(spec.dtype).replace("torch.", "") == \
            str(want[name].dtype), name
        meta = spec.meta()
        assert meta.device.type == "meta" and tuple(meta.shape) == spec.shape
