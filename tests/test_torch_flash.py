"""The port's ``flash_attention`` against the JAX package's.

On CPU tensors the port's ``flash_attention`` takes its plain version
(dense fp32 softmax, GQA by KV-head index).  It is held against the
reference ``flash_attention`` on its CPU path (the XLA twin
``_attention_xla``), against the Pallas kernel in interpret mode, and
against the reference test's numpy oracle, over the grid of
``tests/test_flash_attention.py``.  Tolerances are the reference test's
own: 2e-5 (atol and rtol) in fp32, 0.05 in bf16.  Inputs come from numpy
seeds and reach both sides as the same numbers.

The CUDA kernel itself runs only on a card (``test_torch_gpu.py``).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import (FP32_TOL, flash_attention,
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
