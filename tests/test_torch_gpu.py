"""The hand-written CUDA kernels on the card, against their plain versions.

Every case needs a CUDA card and skips without one (the kernels have no
CPU mode).  On a host with a card and the CUDA toolkit, run them with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports only the port (no JAX), so it also runs where the JAX
package is not installed.  Tolerance: exact byte equality.
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import (CudaEngine, MemECCluster, NumpyEngine,
                              make_code)
from repro_torch.data.ycsb import YCSBConfig, YCSBWorkload, run_workload
from repro_torch.kernels import launch_counts
from repro_torch.kernels.delta_update import (delta_apply_batched,
                                              delta_apply_batched_plain)
from repro_torch.kernels.gf256_matmul import (choose_strategy,
                                              gf01_matmul_batched_plain,
                                              gf256_matmul_batched,
                                              gf256_matmul_batched_plain,
                                              gf256_matmul_per_item_batched,
                                              gf256_matmul_per_item_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _u8(rng, shape, device=None):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    return a if device is None else torch.from_numpy(a).to(device)


@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("C", [16, 1000, 4096])
@pytest.mark.parametrize("m,k", [(2, 8), (10, 8), (1, 4), (4, 10)])
def test_matmul_batched_kernel_matches_plain(cuda, m, k, C, B):
    rng = _rng("mm", m, k, C, B)
    A, D = _u8(rng, (m, k)), _u8(rng, (B, k, C), cuda)
    before = launch_counts()["gf_matmul_batched"]
    got = gf256_matmul_batched(A, D)
    assert torch.equal(got, gf256_matmul_batched_plain(A, D))
    assert launch_counts()["gf_matmul_batched"] == before + 1


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("C", [1000, 4096])
@pytest.mark.parametrize("O,J", [(1, 1), (2, 3), (10, 1)])
def test_per_item_fold_kernel_matches_plain(cuda, O, J, C, B):
    rng = _rng("pi", O, J, C, B)
    Ms = _u8(rng, (B, O, J))
    D, P = _u8(rng, (B, J, C), cuda), _u8(rng, (B, O, C), cuda)
    before = launch_counts()["gf_per_item_fold"]
    got = gf256_matmul_per_item_batched(Ms, D, P)
    assert torch.equal(got, gf256_matmul_per_item_plain(Ms, D, P))
    assert launch_counts()["gf_per_item_fold"] == before + 1


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("C", [1000, 4096])
@pytest.mark.parametrize("m", [1, 2, 10])
def test_delta_kernels_match_plain(cuda, m, C, B):
    rng = _rng("d", m, C, B)
    G = rng.integers(0, 256, (B, m)).astype(np.int32)
    G[0, 0] = 0                                  # a zero coefficient row
    X, P = _u8(rng, (B, C), cuda), _u8(rng, (B, m, C), cuda)
    before = launch_counts()
    assert torch.equal(delta_apply_batched(P, G, X),
                       delta_apply_batched_plain(P, G, X))
    assert torch.equal(delta_apply_batched(None, G, X),
                       delta_apply_batched_plain(None, G, X))
    after = launch_counts()
    for name in ("gf_delta_apply_batched", "gf_delta_only_batched"):
        assert after[name] == before[name] + 1


def _rdp_matrix(which):
    """RDP(10,8)'s (32, 128) encode matrix, or its (160, 128) fused decode
    matrix for two lost data chunks with both parities re-encoded."""
    eng = NumpyEngine(make_code("rdp", 10, 8))
    if which == "encode":
        return eng.rep.encode
    plan = eng.plan_decode([range(2, 10)], [(0, 1, 8, 9)], 4096)
    return eng._fused_decode_matrix(plan.groups[0])


@pytest.mark.parametrize("B", [0, 1, 3, 64])
@pytest.mark.parametrize("C", [256, 1000, 4096])
@pytest.mark.parametrize("which", ["encode", "decode"])
def test_gf01_kernel_matches_plain(cuda, which, C, B):
    A = _rdp_matrix(which)
    assert choose_strategy(A) == "gf01"
    D = _u8(_rng("g01", which, C, B), (B, 128, C), cuda)
    before = launch_counts()["gf01_matmul_batched"]
    got = gf256_matmul_batched(A, D)
    assert torch.equal(got, gf01_matmul_batched_plain(A, D))
    assert torch.equal(got, gf256_matmul_batched_plain(A, D))
    assert launch_counts()["gf01_matmul_batched"] == before + (B > 0)


@pytest.mark.parametrize("B", [0, 1, 3, 64])
@pytest.mark.parametrize("C", [256, 1000, 4096])
@pytest.mark.parametrize("m,k", [(14, 10), (13, 10), (12, 20), (40, 30)])
def test_cols_kernel_matches_plain(cuda, m, k, C, B):
    rng = _rng("cols", m, k, C, B)
    A, D = _u8(rng, (m, k)), _u8(rng, (B, k, C), cuda)
    A[0, 0], A[-1, -1] = 0, 1                 # a zero and a one coefficient
    assert choose_strategy(A) == "cols"
    before = launch_counts()["gf_matmul_cols_batched"]
    got = gf256_matmul_batched(A, D)
    assert torch.equal(got, gf256_matmul_batched_plain(A, D))
    assert launch_counts()["gf_matmul_cols_batched"] == before + (B > 0)


@pytest.mark.parametrize("B", [0, 1, 3, 64])
@pytest.mark.parametrize("C", [256, 1000, 4096])
@pytest.mark.parametrize("zero_one", [True, False])
def test_per_item_kernel_matches_plain(cuda, zero_one, C, B):
    rng = _rng("pin", zero_one, C, B)
    Ms = rng.integers(0, 2 if zero_one else 256, (B, 32, 16), dtype=np.uint8)
    D = _u8(rng, (B, 16, C), cuda)
    before = launch_counts()["gf_per_item"]
    got = gf256_matmul_per_item_batched(Ms, D)
    assert torch.equal(got, gf256_matmul_per_item_plain(Ms, D))
    assert launch_counts()["gf_per_item"] == before + (B > 0)


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("C", [256, 1000])
def test_per_item_fold_kernel_at_the_rdp_seal_shape(cuda, C, B):
    """The seal fold of RDP: one (16, 16) 0/1 system per item."""
    rng = _rng("fold16", C, B)
    Ms = rng.integers(0, 2, (B, 16, 16), dtype=np.uint8)
    D, P = _u8(rng, (B, 16, C), cuda), _u8(rng, (B, 16, C), cuda)
    assert torch.equal(gf256_matmul_per_item_batched(Ms, D, P),
                       gf256_matmul_per_item_plain(Ms, D, P))


def test_unaligned_views_take_the_byte_path(cuda):
    """A view starting one byte into its storage is not 16-byte aligned;
    the kernel must fall back to its byte loop, not fault."""
    rng = _rng("unaligned")
    flat = _u8(rng, (1 + 3 * 8 * 4096,), cuda)
    D = flat[1:].view(3, 8, 4096)
    A = _u8(rng, (2, 8))
    assert torch.equal(gf256_matmul_batched(A, D),
                       gf256_matmul_batched_plain(A, D))
    # the new kernels, on views of the same odd offset
    for A, rows in ((_rdp_matrix("encode"), 128), (_u8(rng, (14, 10)), 10)):
        R = flat[1:1 + 3 * rows * 256].view(3, rows, 256)
        assert torch.equal(gf256_matmul_batched(A, R),
                           gf256_matmul_batched_plain(A, R))
    Ms = rng.integers(0, 2, (3, 32, 16), dtype=np.uint8)
    X = flat[1:1 + 3 * 16 * 256].view(3, 16, 256)
    assert torch.equal(gf256_matmul_per_item_batched(Ms, X),
                       gf256_matmul_per_item_plain(Ms, X))


def test_wrappers_reject_bad_operands(cuda):
    D = torch.zeros((2, 8, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        gf256_matmul_batched(np.ones((2, 8), np.uint8), D.to(torch.int32))
    with pytest.raises(ValueError):
        gf256_matmul_batched(np.ones((2, 8), np.uint8),
                             D.transpose(1, 2).contiguous().transpose(1, 2))
    # parity=None is the plain per-item kernel: it launches
    before = launch_counts()["gf_per_item"]
    out = gf256_matmul_per_item_batched(np.ones((2, 1, 8), np.uint8), D)
    assert tuple(out.shape) == (2, 1, 128)
    assert launch_counts()["gf_per_item"] == before + 1
    with pytest.raises(ValueError, match="gf01"):
        gf256_matmul_batched(np.ones((2, 8000), np.uint8),
                             torch.zeros((1, 8000, 16), dtype=torch.uint8,
                                         device=cuda))


@pytest.mark.parametrize("scheme,n,k", [("rs", 10, 8), ("rs", 6, 4),
                                        ("xor", 5, 4), ("rdp", 10, 8),
                                        ("rs", 14, 10)])
def test_cuda_engine_matches_numpy_engine(cuda, scheme, n, k):
    code = make_code(scheme, n, k)
    eng, ref = CudaEngine(code), NumpyEngine(code)
    r = eng.rep.r
    rng = _rng("eng", scheme, n, k)
    C, B = (1000 if r == 1 else 63 * r), 5
    data = _u8(rng, (B, k, C))
    before = launch_counts()
    par = eng.encode_batch(data)
    np.testing.assert_array_equal(par, ref.encode_batch(data))
    idx = rng.integers(0, k, B)
    xors = _u8(rng, (B, C))
    np.testing.assert_array_equal(eng.delta_batch(idx, xors),
                                  ref.delta_batch(idx, xors))
    np.testing.assert_array_equal(eng.apply_delta_batch(par, idx, xors),
                                  ref.apply_delta_batch(par, idx, xors))
    # odd items also re-encode every parity: RS(14,10) then builds a
    # (14, 10) fused matrix, which takes the column-loop kernel
    avail = [{p: (data[b, p] if p < k else par[b, p - k])
              for p in range(n) if p != b % n} for b in range(B)]
    wanted = [sorted({b % n} | (set(range(k, n)) if b % 2 else set()))
              for b in range(B)]
    for g, w in zip(eng.decode_batch(avail, wanted, C),
                    ref.decode_batch(avail, wanted, C)):
        assert g.keys() == w.keys()
        for p in g:
            np.testing.assert_array_equal(g[p], w[p])
    rows = rng.integers(0, n - k, B)
    prow = _u8(rng, (B, C))
    np.testing.assert_array_equal(
        eng.submit_fold_rows(idx, xors, rows, prow).result(),
        ref.submit_fold_rows(idx, xors, rows, prow).result())
    versions = [_u8(rng, (v, C)) for v in (1, 4, 2, 3, 1)]
    np.testing.assert_array_equal(
        eng.submit_delta_collapse(par, idx, versions).result(),
        ref.submit_delta_collapse(par, idx, versions).result())
    assert set(eng.op_paths.values()) == {"cuda-kernel"}
    want_ops = {"matmul", "delta_per_item"} | ({"delta"} if r == 1 else set())
    assert set(eng.op_paths) == want_ops
    after = launch_counts()
    launched = {name for name in after if after[name] > before[name]}
    if scheme == "rdp":
        assert {"gf01_matmul_batched", "gf_per_item",
                "gf_per_item_fold"} <= launched, launched
    if (n, k) == (14, 10):
        assert "gf_matmul_cols_batched" in launched, launched


@pytest.mark.parametrize("scheme", ["rs", "rdp"])
def test_cluster_on_card_matches_numpy_twin(cuda, scheme):
    kw = dict(num_servers=16, scheme=scheme, n=10, k=8, c=16, chunk_size=512,
              max_unsealed=1)
    cfg = YCSBConfig(num_objects=3000)
    clusters = [MemECCluster(engine="cuda", **kw),
                MemECCluster(engine="numpy", **kw)]
    for cl in clusters:
        run_workload(cl, "load", 0, cfg, batch_size=16)
        run_workload(cl, "A", 1500, cfg, batch_size=16)
        cl.fail_server(3)
        run_workload(cl, "A", 500, cfg, batch_size=16)
        cl.restore_server(3)
    stats = [cl.stats for cl in clusters]
    assert stats[0] == stats[1]
    w = YCSBWorkload(cfg)
    keys = [w.key(i) for i in range(cfg.num_objects)]
    assert clusters[0].multi_get(keys) == clusters[1].multi_get(keys)
    assert set(clusters[0].engine.op_paths.values()) == {"cuda-kernel"}
