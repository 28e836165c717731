"""The kernels' plain torch versions against the JAX package's Pallas kernels.

Each wrapper of the port takes its plain version for CPU tensors; the
reference entry points run here in interpret mode, as the JAX package's
own tests run them.  Every case is also held against the numpy oracle
(``gf_matmul_np``).  Tolerance: exact byte equality (GF(2^8) arithmetic).

The CUDA kernels themselves run only on a card: ``test_torch_gpu.py``
holds each against its plain version there.
"""
import importlib
import zlib

import numpy as np
import pytest
import torch

from repro.core import gf256 as ref_gf
from repro.kernels.delta_update import delta_apply_batched as ref_delta
from repro.kernels.gf256_matmul import gf256_matmul_batched as ref_matmul
from repro.kernels.gf256_matmul import \
    gf256_matmul_per_item_batched as ref_per_item
from repro_torch.kernels import dispatch, launch_counts, ref
from repro_torch.kernels.delta_update import (delta_apply_batched,
                                              delta_apply_per_item_batched)
from repro_torch.kernels.gf256_matmul import (choose_strategy,
                                              gf01_matmul_batched_plain,
                                              gf256_matmul_batched,
                                              gf256_matmul_per_item_batched)

torch.set_num_threads(1)

MK = [(2, 8), (10, 8), (1, 4), (4, 10)]
CS = [128, 1000, 4096]
BS = [0, 1, 3]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def np_matmul_batched(A, D):
    return np.stack([ref_gf.gf_matmul_np(A, d) for d in D]) if len(D) \
        else np.zeros((0, A.shape[0], D.shape[2]), np.uint8)


def np_per_item(Ms, D, P=None):
    out = np.stack(
        [ref_gf.gf_matmul_np(M, d) for M, d in zip(Ms, D)]) if len(D) \
        else np.zeros((0, Ms.shape[1], D.shape[2]), np.uint8)
    return out if P is None else out ^ P


def np_delta(P, G, X):
    out = ref_gf.MUL_TABLE[(G & 255).astype(np.uint8)[:, :, None],
                           X[:, None, :]]
    return out if P is None else out ^ P


# ---------------------------------------------------------------------------
# kernel 1: gf256_matmul_batched (shared matrix)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("C", CS)
@pytest.mark.parametrize("m,k", MK)
def test_matmul_batched_plain_vs_numpy(m, k, C, B):
    rng = _rng("mm", m, k, C, B)
    A, D = _u8(rng, (m, k)), _u8(rng, (B, k, C))
    got = gf256_matmul_batched(A, torch.from_numpy(D))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, m, C)
    np.testing.assert_array_equal(got.numpy(), np_matmul_batched(A, D))


# interpret-mode Pallas compiles per shape: one C per matrix shape
@pytest.mark.parametrize("m,k,C", [(2, 8, 4096), (10, 8, 1000), (1, 4, 128),
                                   (4, 10, 1000)])
def test_matmul_batched_plain_vs_pallas_interpret(m, k, C):
    rng = _rng("mmp", m, k, C)
    A, D = _u8(rng, (m, k)), _u8(rng, (3, k, C))
    want = np.asarray(ref_matmul(A, D, strategy="unroll", interpret=True))
    got = gf256_matmul_batched(A, torch.from_numpy(D)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C", [128, 1000])
def test_matmul_batched_zero_one_matrix(C):
    rng = _rng("01", C)
    A = rng.integers(0, 2, (4, 10), dtype=np.uint8)
    D = _u8(rng, (3, 10, C))
    got = gf256_matmul_batched(A, torch.from_numpy(D)).numpy()
    # a 0/1 matrix is an XOR-select: the product is plain XOR
    want = np.stack([np.bitwise_xor.reduce(
        D[:, A[r].astype(bool)], axis=1) if A[r].any()
        else np.zeros((3, C), np.uint8) for r in range(4)], axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_matmul_batched(A, D))


# ---------------------------------------------------------------------------
# kernels 2 and 3: the column-loop and 0/1 bodies of gf256_matmul_batched
# ---------------------------------------------------------------------------

def _rdp_matrices():
    """RDP(10,8)'s (32, 128) block encode matrix and a (160, 128) fused
    decode matrix: two lost data chunks, both parities re-encoded."""
    from repro.core.codes import make_code as ref_make_code
    from repro.core.engine import NumpyEngine as RefNumpyEngine
    eng = RefNumpyEngine(ref_make_code("rdp", 10, 8))
    plan = eng.plan_decode([range(2, 10)], [(0, 1, 8, 9)], 4096)
    return {"encode": eng.rep.encode,
            "decode": eng._fused_decode_matrix(plan.groups[0])}


@pytest.fixture(scope="module")
def rdp_matrices():
    mats = _rdp_matrices()
    assert mats["encode"].shape == (32, 128)
    assert mats["decode"].shape == (160, 128)
    assert all(int(M.max()) == 1 for M in mats.values())
    return mats


@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("Cb", [32, 256, 1000])
@pytest.mark.parametrize("which", ["encode", "decode"])
def test_gf01_plain_vs_numpy(rdp_matrices, which, Cb, B):
    A = rdp_matrices[which]
    D = _u8(_rng("g01", which, Cb, B), (B, 128, Cb))
    assert choose_strategy(A) == "gf01"
    want = np_matmul_batched(A, D)
    np.testing.assert_array_equal(
        gf01_matmul_batched_plain(A, torch.from_numpy(D)).numpy(), want)
    np.testing.assert_array_equal(
        gf256_matmul_batched(A, torch.from_numpy(D)).numpy(), want)


# interpret-mode Pallas compiles per shape: one C per matrix
@pytest.mark.parametrize("which,Cb", [("encode", 32), ("decode", 256)])
def test_gf01_plain_vs_pallas_interpret(rdp_matrices, which, Cb):
    A = rdp_matrices[which]
    D = _u8(_rng("g01p", which, Cb), (3, 128, Cb))
    want = np.asarray(ref_matmul(A, D, strategy="gf01", interpret=True))
    got = gf256_matmul_batched(A, torch.from_numpy(D), strategy="gf01")
    np.testing.assert_array_equal(got.numpy(), want)


def test_gf01_plain_refuses_a_dense_matrix():
    with pytest.raises(ValueError, match="0/1"):
        gf01_matmul_batched_plain(np.full((2, 3), 2, np.uint8),
                                  torch.zeros((1, 3, 16), dtype=torch.uint8))


@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("C", [32, 256, 1000, 4096])
@pytest.mark.parametrize("m,k", [(12, 20), (13, 10), (14, 10)])
def test_cols_plain_vs_numpy(m, k, C, B):
    rng = _rng("cols", m, k, C, B)
    A, D = _u8(rng, (m, k)), _u8(rng, (B, k, C))
    assert choose_strategy(A) == "cols"
    got = gf256_matmul_batched(A, torch.from_numpy(D))
    np.testing.assert_array_equal(got.numpy(), np_matmul_batched(A, D))


# the JAX package's own dense test shape (tests/test_kernels.py) and the
# RS(14,10) fused decode of four re-encoded parities
@pytest.mark.parametrize("m,k,C", [(12, 20, 200), (14, 10, 256)])
def test_cols_plain_vs_pallas_interpret(m, k, C):
    rng = _rng("colsp", m, k, C)
    A, D = _u8(rng, (m, k)), _u8(rng, (2, k, C))
    want = np.asarray(ref_matmul(A, D, strategy="cols", interpret=True))
    got = gf256_matmul_batched(A, torch.from_numpy(D), strategy="cols")
    np.testing.assert_array_equal(got.numpy(), want)


def _reference_strategy(monkeypatch, A, strategy):
    """The body the JAX package's ``gf256_matmul_batched`` picks for A:
    its three pallas_call launchers are replaced by recorders."""
    # the package exports a function of the module's name: go by module
    jmod = importlib.import_module("repro.kernels.gf256_matmul")
    seen = []
    for body, fn in (("unroll", "_gf_matmul_batched_call"),
                     ("cols", "_gf_matmul_cols_call"),
                     ("gf01", "_gf01_matmul_call")):
        def record(a, data, *, m, body=body, **_):
            seen.append(body)
            return np.zeros((data.shape[0], m, data.shape[2]), np.uint8)
        monkeypatch.setattr(jmod, fn, record)
    jmod.gf256_matmul_batched(A, np.zeros((1, A.shape[1], 128), np.uint8),
                              strategy=strategy, interpret=True)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("strategy", [None, "unroll", "cols", "gf01", "bogus"])
def test_strategy_rule_matches_the_reference(monkeypatch, strategy):
    rng = _rng("rule", strategy)
    for m, k in [(1, 4), (2, 8), (10, 8), (16, 8), (8, 17), (12, 20),
                 (13, 10), (32, 128), (160, 128)]:
        for zero_one in (True, False):
            A = rng.integers(0, 2 if zero_one else 256, (m, k),
                             dtype=np.uint8)
            if not zero_one:
                A[0, 0] = 2                     # surely not 0/1
            assert choose_strategy(A, strategy) == \
                _reference_strategy(monkeypatch, A, strategy), \
                (m, k, zero_one, strategy)


def test_matmul_batched_m_zero():
    D = _u8(_rng("m0"), (3, 8, 1000))
    got = gf256_matmul_batched(np.zeros((0, 8), np.uint8), torch.from_numpy(D))
    assert tuple(got.shape) == (3, 0, 1000)


def test_matmul_batched_rejects_mismatched_data():
    with pytest.raises(ValueError):
        gf256_matmul_batched(np.ones((2, 8), np.uint8),
                             torch.zeros((1, 7, 128), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# kernel 5: per-item fold (and the plain per-item product)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("C", CS)
@pytest.mark.parametrize("O,J", [(1, 1), (2, 3)])
def test_per_item_fold_plain_vs_numpy(O, J, C, B):
    rng = _rng("pi", O, J, C, B)
    Ms, D, P = _u8(rng, (B, O, J)), _u8(rng, (B, J, C)), _u8(rng, (B, O, C))
    got = gf256_matmul_per_item_batched(Ms, torch.from_numpy(D),
                                        torch.from_numpy(P)).numpy()
    np.testing.assert_array_equal(got, np_per_item(Ms, D, P))
    bare = gf256_matmul_per_item_batched(Ms, torch.from_numpy(D)).numpy()
    np.testing.assert_array_equal(bare, np_per_item(Ms, D))


@pytest.mark.parametrize("O,J,C", [(1, 1, 4096), (2, 3, 1000), (10, 1, 128)])
@pytest.mark.parametrize("zero_one", [False, True])
def test_per_item_fold_plain_vs_pallas_interpret(O, J, C, zero_one):
    rng = _rng("pip", O, J, C, zero_one)
    hi = 2 if zero_one else 256
    Ms = rng.integers(0, hi, (3, O, J), dtype=np.uint8)
    D, P = _u8(rng, (3, J, C)), _u8(rng, (3, O, C))
    want = np.asarray(ref_per_item(Ms, D, P, interpret=True))
    got = delta_apply_per_item_batched(torch.from_numpy(P), Ms,
                                       torch.from_numpy(D)).numpy()
    np.testing.assert_array_equal(got, want)


# kernel 4: the per-item product without a parity fold (the RDP delta)

@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("Cb", [32, 256, 1000])
@pytest.mark.parametrize("zero_one", [True, False])
def test_per_item_plain_vs_numpy(zero_one, Cb, B):
    rng = _rng("pin", zero_one, Cb, B)
    Ms = rng.integers(0, 2 if zero_one else 256, (B, 32, 16), dtype=np.uint8)
    D = _u8(rng, (B, 16, Cb))
    got = delta_apply_per_item_batched(None, Ms, torch.from_numpy(D))
    assert tuple(got.shape) == (B, 32, Cb)
    np.testing.assert_array_equal(got.numpy(), np_per_item(Ms, D))


@pytest.mark.parametrize("Cb", [32, 256])
@pytest.mark.parametrize("zero_one", [True, False])
def test_per_item_plain_vs_pallas_interpret(zero_one, Cb):
    rng = _rng("pinp", zero_one, Cb)
    Ms = rng.integers(0, 2 if zero_one else 256, (3, 32, 16), dtype=np.uint8)
    D = _u8(rng, (3, 16, Cb))
    want = np.asarray(ref_per_item(Ms, D, None, interpret=True))
    got = gf256_matmul_per_item_batched(Ms, torch.from_numpy(D)).numpy()
    np.testing.assert_array_equal(got, want)


def test_per_item_parity_is_not_modified_in_place():
    rng = _rng("inplace")
    Ms, D, P = _u8(rng, (3, 2, 3)), _u8(rng, (3, 3, 128)), _u8(rng, (3, 2, 128))
    p = torch.from_numpy(P.copy())
    gf256_matmul_per_item_batched(Ms, torch.from_numpy(D), p)
    np.testing.assert_array_equal(p.numpy(), P)


# ---------------------------------------------------------------------------
# kernels 6 and 7: delta_apply_batched with and without parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("C", CS)
@pytest.mark.parametrize("m", [1, 2, 4, 10])
@pytest.mark.parametrize("with_parity", [True, False])
def test_delta_batched_plain_vs_numpy(with_parity, m, C, B):
    rng = _rng("d", with_parity, m, C, B)
    G = rng.integers(0, 256, (B, m)).astype(np.int32)
    X = _u8(rng, (B, C))
    P = _u8(rng, (B, m, C)) if with_parity else None
    got = delta_apply_batched(None if P is None else torch.from_numpy(P), G,
                              torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, np_delta(P, G, X))


@pytest.mark.parametrize("m,C", [(2, 4096), (10, 1000), (1, 128)])
@pytest.mark.parametrize("with_parity", [True, False])
def test_delta_batched_plain_vs_pallas_interpret(with_parity, m, C):
    rng = _rng("dp", with_parity, m, C)
    G = rng.integers(0, 256, (3, m)).astype(np.int32)
    X = _u8(rng, (3, C))
    P = _u8(rng, (3, m, C)) if with_parity else None
    want = np.asarray(ref_delta(P, G, X, interpret=True))
    got = delta_apply_batched(None if P is None else torch.from_numpy(P), G,
                              torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, want)


def test_delta_batched_m_zero():
    got = delta_apply_batched(None, np.zeros((3, 0), np.int32),
                              torch.zeros((3, 1000), dtype=torch.uint8))
    assert tuple(got.shape) == (3, 0, 1000)


# ---------------------------------------------------------------------------
# the torch oracles against the JAX package's
# ---------------------------------------------------------------------------

def test_ref_oracles_match_reference():
    from repro.kernels import ref as jref
    rng = _rng("ref")
    a, b = _u8(rng, (64, 33)), _u8(rng, (64, 33))
    np.testing.assert_array_equal(
        ref.gf256_mul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jref.gf256_mul_ref(a, b)))
    A, D = _u8(rng, (4, 10)), _u8(rng, (10, 1000))
    np.testing.assert_array_equal(
        ref.gf256_matmul_ref(torch.from_numpy(A), torch.from_numpy(D)).numpy(),
        np.asarray(jref.gf256_matmul_ref(A, D)))
    P, g, old, new = _u8(rng, (4, 1000)), _u8(rng, (4,)), _u8(rng, (1000,)), \
        _u8(rng, (1000,))
    np.testing.assert_array_equal(
        ref.delta_update_ref(*map(torch.from_numpy, (P, g, old, new))).numpy(),
        np.asarray(jref.delta_update_ref(P, g, old, new)))


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = launch_counts()
    rng = _rng("cpu")
    A, D = _u8(rng, (2, 8)), _u8(rng, (3, 8, 128))
    assert dispatch.decide(torch.from_numpy(D)).path == dispatch.TORCH_CPU
    gf256_matmul_batched(A, torch.from_numpy(D))
    delta_apply_batched(None, np.ones((3, 2), np.int32),
                        torch.from_numpy(D[:, 0]))
    assert launch_counts() == before


def test_dispatch_policy():
    assert dispatch.decide(torch.zeros(1)).path == dispatch.TORCH_CPU
    assert dispatch.decide("cpu").path == dispatch.TORCH_CPU
    assert dispatch.decide("cuda").path == dispatch.CUDA
    assert dispatch.decide("cuda").kernel
    assert dispatch.describe("cpu")["path"] == dispatch.TORCH_CPU
    assert dispatch.resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device(None)
    assert dispatch.describe("cpu") == {"backend": "cpu",
                                        "path": dispatch.TORCH_CPU}
    # the path follows the data, never the host: no card needed to name it
    assert dispatch.describe("cuda") == {"backend": "cuda",
                                         "path": dispatch.CUDA}
