"""The hand-written CUDA kernels on the card, against their plain versions.

Every case needs a CUDA card and skips without one (the kernels have no
CPU mode).  On a host with a card and the CUDA toolkit, run them with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports only the port (no JAX), so it also runs where the JAX
package is not installed.  Tolerance: exact byte equality.
"""
import importlib
import threading
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import (CudaEngine, MemECCluster, NumpyEngine,
                              make_cluster, make_code)
from repro_torch.core.codes import RSCode
from repro_torch.core.index import CuckooIndex
from repro_torch.data.ycsb import YCSBConfig, YCSBWorkload, run_workload
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels.delta_update import (delta_apply_batched,
                                              delta_apply_batched_plain,
                                              delta_update,
                                              delta_update_plain)
from repro_torch.kernels.gf256_matmul import (choose_strategy,
                                              gf01_matmul_batched_plain,
                                              gf256_matmul,
                                              gf256_matmul_batched,
                                              gf256_matmul_batched_plain,
                                              gf256_matmul_plain,
                                              gf256_matmul_per_item_batched,
                                              gf256_matmul_per_item_plain)

probe = importlib.import_module("repro_torch.kernels.cuckoo_lookup")

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


# ---------------------------------------------------------------------------
# kernels 8-10: the single-stripe product, the fused old/new delta and the
# cuckoo probe (the entry points of kernels/ops.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 1000, 4096, 1 << 20])
@pytest.mark.parametrize("m,k", [(2, 8), (8, 8), (10, 8), (1, 4)])
def test_single_matmul_kernel_matches_plain(cuda, m, k, C):
    rng = _rng("mm1", m, k, C)
    A, D = _u8(rng, (m, k)), _u8(rng, (k, C), cuda)
    before = launch_counts()["gf_matmul"]
    got = gf256_matmul(A, D)
    assert torch.equal(got, gf256_matmul_plain(A, D))
    assert launch_counts()["gf_matmul"] == before + 1


@pytest.mark.parametrize("shape,zero_one,kernel", [
    ((32, 128), True, "gf01_matmul_batched"),
    ((12, 20), False, "gf_matmul_cols_batched")])
def test_single_matmul_above_the_unroll_rule(cuda, shape, zero_one, kernel):
    rng = _rng("mm1-big", shape)
    A = ((rng.integers(0, 4, shape) == 0).astype(np.uint8) if zero_one
         else _u8(rng, shape))
    D = _u8(rng, (shape[1], 1000), cuda)
    before = launch_counts()
    got = gf256_matmul(A, D)
    want = (gf01_matmul_batched_plain(A, D[None])[0] if zero_one
            else gf256_matmul_plain(A, D))
    assert torch.equal(got, want)
    after = launch_counts()
    assert after[kernel] == before[kernel] + 1
    assert after["gf_matmul"] == before["gf_matmul"]


@pytest.mark.parametrize("C", [1, 1000, 4096, 1 << 20])
@pytest.mark.parametrize("m", [1, 2, 14])
def test_delta_update_kernel_matches_plain(cuda, m, C):
    rng = _rng("du", m, C)
    G = rng.integers(0, 256, m).astype(np.int32)
    G[0] = 0                                     # a zero gamma row
    P = _u8(rng, (m, C), cuda)
    old, new = _u8(rng, (C,), cuda), _u8(rng, (C,), cuda)
    before = launch_counts()["gf_delta_update"]
    got = delta_update(P, G, old, new)
    assert torch.equal(got, delta_update_plain(P, G, old, new))
    assert launch_counts()["gf_delta_update"] == before + 1
    # the operands are read, never written
    assert torch.equal(P, delta_update_plain(got, G, old, new))


def test_delta_update_unaligned_views_take_the_byte_path(cuda):
    rng = _rng("du-unaligned")
    flat = _u8(rng, (1 + 4 * 4096,), cuda)
    P = flat[1:1 + 2 * 4096].view(2, 4096)
    old, new = flat[1 + 2 * 4096:1 + 3 * 4096], flat[1 + 3 * 4096:]
    G = np.array([7, 200], np.int32)
    assert torch.equal(delta_update(P, G, old, new),
                       delta_update_plain(P, G, old, new))


def _probe_table(rng, nbuckets, Q):
    fps = np.frombuffer(rng.bytes(8 * nbuckets * 4), np.uint64).reshape(
        nbuckets, 4).copy()
    occ = rng.random((nbuckets, 4)) < 0.9
    h1 = np.frombuffer(rng.bytes(8 * Q), np.uint64).copy()
    h2 = np.frombuffer(rng.bytes(8 * Q), np.uint64).copy()
    fp = np.frombuffer(rng.bytes(8 * Q), np.uint64).copy()
    h2[::9] = h1[::9]                            # both probes on one bucket
    hits = rng.choice(np.flatnonzero(occ), (Q + 1) // 2)
    for q, flat in zip(range(0, Q, 2), hits):
        b = int(flat) // 4
        fp[q] = fps.reshape(-1)[flat]
        h = np.uint64(b + nbuckets * int(rng.integers(0, 1 << 30)))
        if q % 9 == 0:
            h1[q] = h2[q] = h
        elif q % 4:
            h1[q] = h
        else:
            h2[q] = h
    return fps, occ, h1, h2, fp


@pytest.mark.parametrize("Q", [1, 64, 65536])
def test_cuckoo_probe_kernel_matches_plain(cuda, Q):
    rng = _rng("probe", Q)
    fps, occ, h1, h2, fp = _probe_table(rng, 1 << 12, Q)
    fps_d = torch.from_numpy(fps.view(np.int64)).to(cuda)
    occ_d = torch.from_numpy(occ).to(cuda)
    before = launch_counts()["gf_cuckoo_probe"]
    found, slot = probe.cuckoo_lookup(fps_d, occ_d, h1, h2, fp)
    assert launch_counts()["gf_cuckoo_probe"] == before + 1
    pf, ps = probe.cuckoo_probe_plain(
        fps_d, occ_d, *probe.query_tensors(h1, h2, fp, 1 << 12, cuda))
    assert torch.equal(found, pf) and torch.equal(slot, ps)
    cf, cs = probe.cuckoo_lookup(fps, occ, h1, h2, fp, device="cpu")
    assert torch.equal(found.cpu(), cf) and torch.equal(slot.cpu(), cs)
    assert bool(found[0]) and (Q == 1 or not bool(found.all()))


def test_ops_on_the_card_match_the_host(cuda):
    rng = _rng("ops")
    code = RSCode(n=10, k=8)
    data = _u8(rng, (8, 4096))
    par = ops.encode_stripe(code, data)          # numpy in: the card
    assert par.device.type == "cuda"
    np.testing.assert_array_equal(par.cpu().numpy(), code.encode(data))
    stripe = torch.cat([torch.from_numpy(data).to(cuda), par])
    rec = ops.decode_stripe(code, {i: stripe[i] for i in range(10)
                                   if i not in (0, 8)}, [0, 8], 4096)
    assert torch.equal(rec[0], stripe[0]) and torch.equal(rec[8], stripe[8])
    new = data[5].copy()
    new[:300] ^= 0x5A
    upd = ops.apply_parity_delta(code, par, 5, stripe[5],
                                 torch.from_numpy(new).to(cuda))
    d2 = data.copy()
    d2[5] = new
    np.testing.assert_array_equal(upd.cpu().numpy(), code.encode(d2))
    index = CuckooIndex(num_buckets=256)
    keys = [b"obj%06d" % i for i in range(800)]
    for i, key in enumerate(keys):
        index.insert(key, i)
    probe_keys = keys[::3] + [b"nope%04d" % i for i in range(40)]
    found, slot = ops.batched_index_lookup(index, probe_keys)
    assert found.device.type == "cuda"
    assert found.cpu().numpy().tolist() == [k in index for k in probe_keys]
    rf, rs = ops.batched_index_lookup(index, probe_keys, use_ref=True)
    assert torch.equal(found, rf) and torch.equal(slot, rs)


# ---------------------------------------------------------------------------
# the sharded cluster on the card: shard engines run on worker threads
# ---------------------------------------------------------------------------

SHARD_KW = dict(num_servers=10, num_proxies=2, scheme="rs", n=4, k=2, c=8,
                chunk_size=256, max_unsealed=2)


def test_sharded_scatter_loses_no_launch_counts(cuda):
    cl = make_cluster(shards=2, engine="cuda", **SHARD_KW)
    assert cl.pipeline
    rng = _rng("scatter")
    A = _u8(rng, (2, 8))
    D = _u8(rng, (4, 8, 4096), cuda)
    threads = set()

    def launch_many(si, idxs):
        threads.add(threading.get_ident())
        for _ in range(500):
            gf256_matmul_batched(A, D)
        return si
    before = launch_counts()["gf_matmul_batched"]
    out = cl._scatter(launch_many, {0: [0], 1: [1]})
    torch.cuda.synchronize()
    assert sorted(si for si, _, _ in out) == [0, 1] and len(threads) == 2
    assert launch_counts()["gf_matmul_batched"] == before + 1000


def test_sharded_cluster_on_card_matches_numpy_twin(cuda):
    cfg = YCSBConfig(num_objects=1500)
    clusters = [make_cluster(shards=3, placement="ring", engine=e,
                             **SHARD_KW) for e in ("cuda", "numpy")]
    reports = []
    for cl in clusters:
        run_workload(cl, "load", 0, cfg, batch_size=16)
        run_workload(cl, "A", 1500, cfg, batch_size=16)
        rep = [cl.fail_server(3, shard=1)]
        run_workload(cl, "A", 500, cfg, batch_size=16)
        rep.append(cl.restore_server(3, shard=1))
        rep.append(cl.add_shard(batch_size=32))
        reports.append(rep)
    assert reports[0] == reports[1]
    assert clusters[0].stats == clusters[1].stats
    w = YCSBWorkload(cfg)
    keys = [w.key(i) for i in range(cfg.num_objects)]
    assert clusters[0].multi_get(keys) == clusters[1].multi_get(keys)
    for eng in clusters[0].engines[:3]:
        assert set(eng.op_paths.values()) == {"cuda-kernel"}
