"""The port's ``flash_attention`` against the JAX package's.

On CPU tensors the port's ``flash_attention`` takes its plain version
(dense fp32 softmax, GQA by KV-head index).  It is held against the
reference ``flash_attention`` on its CPU path (the XLA twin
``_attention_xla``), against the Pallas kernel in interpret mode, and
against the reference test's numpy oracle, over the grid of
``tests/test_flash_attention.py``.  Tolerances are the reference test's
own: 2e-5 (atol and rtol) in fp32, 0.05 in bf16.  Inputs come from numpy
seeds and reach both sides as the same numbers.

The CUDA kernel itself runs only on a card (``test_torch_gpu.py``); here
a plain torch emulation of its bf16 arithmetic (``_wgmma_body``: 64-key
tiles, the online softmax, P split into bf16 hi + lo terms, fp32 sums) is
held against the plain version within ``tolerance``, and the same body
with P rounded once to bf16 is shown to miss it.

The training backward (``flash_attention_backward``, reached through
``flash_attention``'s autograd function) is held element by element
against autograd through the plain version, and in fp32 against
``jax.vjp`` of the reference, at lengths of several ``BWD_BLOCK_Q``
query tiles: max |got - want| <= ``BWD_TOL`` x max |want| per gradient.
A backward whose dK sums the first tile alone must miss that bound.
"""
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import (BWD_BLOCK_Q, FP32_TOL,
                                                 NEG_INF,
                                                 flash_attention_backward,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 tolerance, tolerance_ratio)
from test_flash_attention import oracle

torch.set_num_threads(1)

# (B, S, H, KV, hd, block_q, block_kv): tests/test_flash_attention.py
GRID = [
    (2, 256, 4, 2, 64, 128, 128),
    (1, 200, 8, 8, 32, 128, 64),     # MHA + ragged seq (padding path)
    (2, 384, 6, 3, 128, 128, 256),
    (1, 64, 2, 1, 16, 32, 32),       # MQA
]
TOL = {"float32": 2e-5, "bfloat16": 0.05}


def _qkv(B, S, H, KV, hd, Skv=None):
    rng = np.random.default_rng(zlib.crc32(repr((B, S, H, KV, hd)).encode()))
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _port(arrs, dtype, **kw):
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return flash_attention(*t, **kw).float().numpy()


def _ref(arrs, dtype, **kw):
    out = ref_flash(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs),
                    **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bkv", GRID)
def test_plain_matches_reference_and_oracle(B, S, H, KV, hd, bq, bkv, dtype):
    arrs = _qkv(B, S, H, KV, hd)
    got = _port(arrs, dtype, block_q=bq, block_kv=bkv)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, _ref(arrs, dtype, block_q=bq,
                                         block_kv=bkv), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle(*arrs), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd,bq,bkv", GRID)
def test_plain_matches_interpret_mode_pallas(B, S, H, KV, hd, bq, bkv):
    """The causal cases against the Pallas body itself (interpret mode)."""
    arrs = _qkv(B, S, H, KV, hd)
    got = _port(arrs, "float32", block_q=bq, block_kv=bkv)
    want = _ref(arrs, "float32", block_q=bq, block_kv=bkv, interpret=True)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


#: the head dims kernel 11 gained for kimi-k2 (112) and recurrentgemma-2b
#: (256), causal and tile-aligned (the reference's Pallas body masks
#: padded keys only through the causal test: ROADMAP Queue 3)
NEW_HEAD_DIMS = [(1, 256, 8, 2, 112, 128, 128), (2, 256, 4, 1, 256, 64, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bkv", NEW_HEAD_DIMS)
def test_plain_matches_reference_at_new_head_dims(B, S, H, KV, hd, bq, bkv,
                                                  dtype):
    arrs = _qkv(B, S, H, KV, hd)
    got = _port(arrs, dtype, block_q=bq, block_kv=bkv)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, _ref(arrs, dtype, block_q=bq,
                                         block_kv=bkv), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle(*arrs), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd,bq,bkv", NEW_HEAD_DIMS)
def test_plain_matches_interpret_mode_pallas_at_new_head_dims(B, S, H, KV, hd,
                                                              bq, bkv):
    arrs = _qkv(B, S, H, KV, hd)
    got = _port(arrs, "float32", block_q=bq, block_kv=bkv)
    want = _ref(arrs, "float32", block_q=bq, block_kv=bkv, interpret=True)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_matches_reference(dtype):
    arrs = _qkv(1, 128, 4, 4, 32)
    got = _port(arrs, dtype, causal=False, block_q=64, block_kv=64)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, _ref(arrs, dtype, causal=False,
                                         block_q=64, block_kv=64),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle(*arrs, causal=False),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_ragged_matches_oracle(dtype):
    """Non-causal with S = 100 and 64-row KV tiles, against the oracle
    only: the reference's Pallas body pads K/V to a multiple of its KV
    tile with zero keys and masks them only through the causal test, so
    here they enter its softmax (off the oracle by about 0.1 in interpret
    mode).  The port masks keys past Skv in every call, as the oracle and
    the reference's CPU path do."""
    arrs = _qkv(1, 100, 2, 2, 16)
    got = _port(arrs, dtype, causal=False, block_q=64, block_kv=64)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, oracle(*arrs, causal=False),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got, _ref(arrs, dtype, causal=False,
                                         block_q=64, block_kv=64),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_cross_lengths_match_oracle(causal):
    """Sq != Skv: causal masking by absolute positions, as the oracle."""
    q, _, _ = _qkv(1, 48, 4, 2, 32)
    _, k, v = _qkv(1, 48, 4, 2, 32, Skv=80)
    got = _port((q, k, v), "float32", causal=causal)
    np.testing.assert_allclose(got, oracle(q, k, v, causal=causal),
                               atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    arrs = [torch.from_numpy(a) for a in _qkv(1, 64, 4, 2, 96)]
    before = launch_counts()["flash_attention"]
    got = flash_attention(*arrs)   # hd 96: the kernel would refuse it
    assert launch_counts()["flash_attention"] == before
    torch.testing.assert_close(got, flash_attention_plain(*arrs),
                               atol=0, rtol=0)
    assert got.dtype == torch.float32 and got.shape == (1, 64, 4, 96)


@pytest.mark.parametrize("bad", ["kv_heads", "head_dim", "rank", "no_keys",
                                 "block"])
def test_bad_arguments_raise(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 32, 4, 2, 16))
    kw = {}
    if bad == "kv_heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "head_dim":
        k, v = k[..., :8], v[..., :8]
    elif bad == "rank":
        q = q[0]
    elif bad == "no_keys":
        k, v = k[:, :0], v[:, :0]
    else:
        kw = {"block_q": 0}
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


def test_tolerance_is_per_element():
    """The kernel's bound against its plain version: 1e-4 in fp32, and in
    bf16 1e-4 + 2 ulps of each element's own magnitude."""
    want = torch.tensor([1.0, 0.03, 0.0, -2.5, 3.25])
    assert torch.equal(tolerance(want), torch.full((5,), FP32_TOL))
    ulps = torch.tensor([2.0 ** -7, 2.0 ** -13, 2.0 ** -133, 2.0 ** -6,
                         2.0 ** -6])
    torch.testing.assert_close(tolerance(want.to(torch.bfloat16)),
                               FP32_TOL + 2 * ulps, atol=0, rtol=0)


def _causal_f64(q, k, v, keep=None):
    """Causal GQA attention summed in float64 (another order than the
    plain version's fp32), rounded once to q's dtype; ``keep`` narrows
    the keys each query row sees."""
    S, H, hd = q.shape[1], q.shape[2], q.shape[3]
    idx = torch.arange(H) // (H // k.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                     k[:, :, idx].double()) / hd ** 0.5
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    mask = j <= i if keep is None else (j <= i) & keep(i, j)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v[:, :, idx].double()).to(q.dtype)


@pytest.mark.parametrize("fault", ["diagonal_tile", "key0"])
def test_tolerance_holds_rounding_and_fails_a_late_fault(fault):
    """bf16 outputs summed in another order stay within the bound.  Ones
    where late query rows miss keys do not: the last 64 rows skipping
    their diagonal 64-key tile, or the second half of the rows skipping
    key 0."""
    B, S, H, KV, hd = 1, 2048, 4, 2, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(B, S, H, KV, hd))
    want = flash_attention_plain(q, k, v)
    assert tolerance_ratio(_causal_f64(q, k, v), want) <= 1.0
    keep = {"diagonal_tile": lambda i, j: (i < S - 64) | (j < S - 64),
            "key0": lambda i, j: (i < S // 2) | (j >= 1)}[fault]
    assert tolerance_ratio(_causal_f64(q, k, v, keep=keep), want) > 1.0


def _wgmma_body(q, k, v, *, causal=True, split=True):
    """A plain torch emulation of the bf16 CUDA body's arithmetic: 64-key
    tiles (keys past Skv as the zero rows TMA loads, masked), the online
    softmax in base 2 with fp32 sums, and P V from P as two bf16 terms,
    hi = bf16(p) and lo = bf16(p - hi), or as hi alone when not
    ``split``.  Each product is exact in fp32, as on the tensor cores."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    idx = torch.arange(H) // (H // KV)
    qf = q.float().transpose(1, 2)
    kf = k[:, :, idx].float().transpose(1, 2)
    vf = v[:, :, idx].float().transpose(1, 2)
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(hd))
    m = torch.full((B, H, Sq, 1), NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, hd))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, 64):
        keys = torch.arange(k0, k0 + 64)[None, :]
        pad = (0, 0, 0, k0 + 64 - min(k0 + 64, Skv))
        kt = torch.nn.functional.pad(kf[:, :, k0:k0 + 64], pad)
        vt = torch.nn.functional.pad(vf[:, :, k0:k0 + 64], pad)
        masked = keys >= Skv
        if causal:
            masked = masked | (keys > rows)
        s = ((qf @ kt.transpose(-1, -2)) * scale_log2).masked_fill(masked,
                                                                   NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        o = o * alpha + hi @ vt
        if split:
            o = o + (p - hi).to(torch.bfloat16).float() @ vt
        m = m_new
    return (o / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


# (B, Sq, Skv, H, KV, hd, causal): hd 128 at S >= 1,024, a ragged
# non-causal case and cross lengths
BODY_GRID = [(1, 1024, 1024, 4, 1, 128, True),
             (1, 2048, 2048, 4, 2, 128, True),
             (2, 1024, 1024, 4, 2, 64, True),
             (1, 1000, 1000, 4, 2, 128, False),
             (1, 300, 1100, 4, 2, 128, True),
             (1, 1100, 300, 4, 2, 128, True)]


def _bf16_inputs(B, Sq, Skv, H, KV, hd):
    q, _, _ = _qkv(B, Sq, H, KV, hd)
    _, k, v = _qkv(B, Sq, H, KV, hd, Skv=Skv)
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", BODY_GRID)
def test_split_p_body_holds_the_tolerance(B, Sq, Skv, H, KV, hd, causal):
    """The bf16 kernel's arithmetic (P split hi + lo) stays within
    ``tolerance`` of the plain version (about half of it: one bf16 ulp)."""
    q, k, v = _bf16_inputs(B, Sq, Skv, H, KV, hd)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert tolerance_ratio(_wgmma_body(q, k, v, causal=causal), want) <= 1.0


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", [
    (1, 1024, 1024, 10, 1, 256, True), (1, 1024, 1024, 8, 2, 112, True),
    (1, 600, 300, 4, 2, 112, False)])
def test_split_p_body_holds_the_tolerance_at_new_head_dims(B, Sq, Skv, H, KV,
                                                           hd, causal):
    """The same arithmetic at hd 256 (recurrentgemma-2b: each of the two
    warpgroups sums its 128 columns of O from the same P, so the
    emulation is the same) and hd 112 (kimi-k2: the zero-filled columns
    add nothing)."""
    q, k, v = _bf16_inputs(B, Sq, Skv, H, KV, hd)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert tolerance_ratio(_wgmma_body(q, k, v, causal=causal), want) <= 1.0


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", BODY_GRID[:3])
def test_single_bf16_p_exceeds_the_tolerance(B, Sq, Skv, H, KV, hd, causal):
    """Why P is split: rounded once to bf16, as flash kernels commonly do,
    it puts outputs 9 to 15 times the per-element bound off."""
    q, k, v = _bf16_inputs(B, Sq, Skv, H, KV, hd)
    want = flash_attention_plain(q, k, v, causal=causal)
    got = _wgmma_body(q, k, v, causal=causal, split=False)
    assert tolerance_ratio(got, want) > 1.0


# (B, Sq, Skv, H, KV, hd, causal): three 256-row query tiles, the last
# ragged, GQA; a cross-length case whose keys outrun the queries; the
# head dims of kimi-k2 (112) and recurrentgemma-2b (256, one KV head)
BWD_GRID = [(1, 600, 600, 4, 2, 32, True),
            (1, 600, 600, 4, 2, 32, False),
            (2, 600, 700, 6, 2, 16, True)]
BWD_WIDE = [(1, 600, 600, 8, 2, 112, True),
            (1, 600, 600, 4, 1, 256, True)]
# max |got - want| over max |want|, per gradient.  Measured at BWD_GRID:
# fp32 <= 1.1e-6 against autograd (<= 9e-7 against jax.vjp); bf16
# <= 6.3e-3, one and a half bf16 ulps of the largest element, from the
# final rounding and from rowsum(dO * O) reading the rounded output.
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _bwd_inputs(B, Sq, Skv, H, KV, hd, dtype):
    q, _, _ = _qkv(B, Sq, H, KV, hd)
    _, k, v = _qkv(B, Sq, H, KV, hd, Skv=Skv)
    dout = np.random.default_rng(Sq + Skv).standard_normal(
        q.shape).astype(np.float32)
    return tuple(torch.from_numpy(a).to(getattr(torch, dtype))
                 for a in (q, k, v, dout))


def _grads(fn, q, k, v, dout, causal):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, causal=causal)
    out.backward(dout)
    return out.detach(), [t.grad for t in leaves]


def _rel_err(got, want):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal", BWD_GRID + BWD_WIDE)
def test_backward_matches_autograd_of_plain(B, Sq, Skv, H, KV, hd, causal,
                                            dtype):
    """dq, dk, dv of ``flash_attention`` (its autograd function) against
    autograd through ``flash_attention_plain``, over several query
    tiles."""
    assert Sq > 2 * BWD_BLOCK_Q
    q, k, v, dout = _bwd_inputs(B, Sq, Skv, H, KV, hd, dtype)
    _, got = _grads(flash_attention, q, k, v, dout, causal)
    _, want = _grads(flash_attention_plain, q, k, v, dout, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype == q.dtype
        assert _rel_err(g, w) <= BWD_TOL[dtype], name


@pytest.mark.parametrize("shape,causal", [
    pytest.param((1, 600, 600, 4, 2, 32), True, id="True"),
    pytest.param((1, 600, 600, 4, 2, 32), False, id="False"),
    *(pytest.param(p[:6], p[6], id=f"hd{p[5]}") for p in BWD_WIDE)])
def test_backward_matches_reference_vjp(shape, causal):
    """fp32 gradients against ``jax.vjp`` of the reference's attention, at
    hd 32, 112 and 256."""
    q, k, v, dout = _bwd_inputs(*shape, "float32")
    _, f = jax.vjp(lambda *a: ref_flash(*a, causal=causal),
                   *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = f(jnp.asarray(dout.numpy()))
    out = flash_attention_plain(q, k, v, causal=causal)
    got = flash_attention_backward(q, k, v, out, dout, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert _rel_err(g, np.array(w)) <= BWD_TOL["float32"], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_missing_later_tiles_fails(causal, dtype):
    """Control: dK summed over the first query tile alone (what a
    backward that dropped later tiles' contributions would give) misses
    ``BWD_TOL``."""
    q, k, v, dout = _bwd_inputs(1, 600, 600, 4, 2, 32, dtype)
    out, want = _grads(flash_attention_plain, q, k, v, dout, causal)
    t = slice(0, BWD_BLOCK_Q)
    _, dk_first, _ = flash_attention_backward(q[:, t], k, v, out[:, t],
                                              dout[:, t], causal=causal)
    assert _rel_err(dk_first, want[1]) > BWD_TOL[dtype]
