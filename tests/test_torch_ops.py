"""The port's ``kernels/ops.py`` and kernels 8-10 against the JAX package.

The public entry points (``encode_stripe``, ``decode_stripe``,
``apply_parity_delta``, ``batched_index_lookup``) run on CPU tensors, so
every kernel call takes its plain version, and are held against
``repro.kernels.ops`` as the JAX package's own tests run it on the CPU,
with ``use_ref`` both ways.  The plain versions of the single-stripe
product, the fused old/new delta and the cuckoo probe are held against
the reference's Pallas kernels in interpret mode.  Inputs come from
numpy seeds; tolerance: exact equality (GF(2^8) and the probe are exact).

The CUDA kernels themselves run only on a card (``test_torch_gpu.py``).
"""
import ctypes.util
import importlib
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codes import RSCode as RefRSCode
from repro.core.index import CuckooIndex as RefCuckooIndex
from repro.kernels import ops as ref_ops
from repro.kernels.cuckoo_lookup import cuckoo_lookup as ref_cuckoo_lookup
from repro.kernels.delta_update import delta_update as ref_delta_update
from repro.kernels.gf256_matmul import gf256_matmul as ref_gf256_matmul
from repro_torch.core.codes import RSCode
from repro_torch.core.index import CuckooIndex
from repro_torch.kernels import _build, launch_counts, ops
from repro_torch.kernels.cuckoo_lookup import cuckoo_lookup
from repro_torch.kernels.delta_update import delta_update, delta_update_plain
from repro_torch.kernels.gf256_matmul import (gf256_matmul,
                                              gf256_matmul_plain)

torch.set_num_threads(1)

# RS(n, k) over the (m, k) grid of tests/test_kernels.py
CODES = [(10, 8), (14, 10), (5, 4), (16, 8)]
CS = [128, 999, 4096]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)



# ---------------------------------------------------------------------------
# ops entry points against repro.kernels.ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_ref", [False, True])
@pytest.mark.parametrize("C", CS)
@pytest.mark.parametrize("n,k", CODES)
def test_encode_decode_stripe_match_reference(n, k, C, use_ref):
    rng = _rng("stripe", n, k, C)
    code, ref_code = RSCode(n=n, k=k), RefRSCode(n=n, k=k)
    data = _u8(rng, (k, C))
    par = ops.encode_stripe(code, torch.from_numpy(data), use_ref=use_ref)
    ref_par = ref_ops.encode_stripe(ref_code, jnp.asarray(data),
                                    use_ref=use_ref)
    assert par.dtype == torch.uint8 and par.device.type == "cpu"
    np.testing.assert_array_equal(par.numpy(), np.asarray(ref_par))
    np.testing.assert_array_equal(par.numpy(), code.encode(data))
    stripe = np.concatenate([data, par.numpy()])
    lost = sorted({0, k - 1, k, n - 1})[:n - k]     # data and parity
    avail = {i: stripe[i] for i in range(n) if i not in lost}
    got = ops.decode_stripe(code, avail, lost, C, use_ref=use_ref,
                            device="cpu")
    want = ref_ops.decode_stripe(ref_code, {i: jnp.asarray(v)
                                            for i, v in avail.items()},
                                 lost, C, use_ref=use_ref)
    assert sorted(got) == sorted(want) == lost
    for w in lost:
        np.testing.assert_array_equal(got[w].numpy(), np.asarray(want[w]))
        np.testing.assert_array_equal(got[w].numpy(), stripe[w])


@pytest.mark.parametrize("use_ref", [False, True])
@pytest.mark.parametrize("C", CS)
@pytest.mark.parametrize("n,k", CODES)
def test_apply_parity_delta_matches_reference(n, k, C, use_ref):
    rng = _rng("delta", n, k, C)
    code, ref_code = RSCode(n=n, k=k), RefRSCode(n=n, k=k)
    data = _u8(rng, (k, C))
    par = code.encode(data)
    i = int(rng.integers(0, k))
    new = data[i].copy()
    new[C // 4:C // 2] = _u8(rng, C // 2 - C // 4)
    got = ops.apply_parity_delta(code, par, i, data[i], new,
                                 use_ref=use_ref, device="cpu")
    want = ref_ops.apply_parity_delta(ref_code, jnp.asarray(par), i,
                                      jnp.asarray(data[i]), jnp.asarray(new),
                                      use_ref=use_ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d2 = data.copy()
    d2[i] = new
    np.testing.assert_array_equal(got.numpy(), code.encode(d2))


def _filled_indexes(nbuckets, n_keys):
    idx, ref_idx = CuckooIndex(num_buckets=nbuckets), \
        RefCuckooIndex(num_buckets=nbuckets)
    keys = [b"obj%06d" % i for i in range(n_keys)]
    for i, key in enumerate(keys):
        idx.insert(key, i)
        ref_idx.insert(key, i)
    return idx, ref_idx, keys


@pytest.mark.parametrize("use_ref", [False, True])
@pytest.mark.parametrize("nbuckets,n_keys", [(64, 100), (256, 800)])
def test_batched_index_lookup_matches_reference(nbuckets, n_keys, use_ref):
    idx, ref_idx, keys = _filled_indexes(nbuckets, n_keys)
    probe = keys[::3] + [b"nope%04d" % i for i in range(40)]
    found, slot = ops.batched_index_lookup(idx, probe, use_ref=use_ref,
                                           device="cpu")
    rf, rs = ref_ops.batched_index_lookup(ref_idx, probe, use_ref=use_ref)
    assert found.dtype == torch.bool and slot.dtype == torch.int32
    np.testing.assert_array_equal(found.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(found.numpy(), [k in idx for k in probe])
    for key, f, s in zip(probe, found.numpy(), slot.numpy()):
        if f:
            assert idx.slot_data[divmod(int(s), 4)][0] == key


def test_bytes_round_trip_matches_reference():
    rng = _rng("bytes")
    x = rng.standard_normal((3, 5)).astype(np.float32)
    b = ops.bytes_of(torch.from_numpy(x))
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(ref_ops.bytes_of(jnp.asarray(x))))
    np.testing.assert_array_equal(
        ops.from_bytes(b, torch.float32, (3, 5)).numpy(), x)


def test_numpy_input_without_a_device_goes_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the call would run there")
    code = RSCode(n=10, k=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.encode_stripe(code, np.zeros((8, 64), np.uint8))
    # a CPU tensor runs where it lies
    assert ops.encode_stripe(code, torch.zeros(8, 64, dtype=torch.uint8)
                             ).device.type == "cpu"


# ---------------------------------------------------------------------------
# plain versions of kernels 8-10 against interpret-mode Pallas
# ---------------------------------------------------------------------------

# interpret-mode Pallas compiles per shape: a few shapes of the ops path
@pytest.mark.parametrize("m,k,C", [(2, 8, 4096), (8, 8, 1000), (4, 10, 128),
                                   (1, 4, 999)])
def test_single_matmul_plain_matches_pallas(m, k, C):
    rng = _rng("mm1", m, k, C)
    A, D = _u8(rng, (m, k)), _u8(rng, (k, C))
    want = np.asarray(ref_gf256_matmul(A, jnp.asarray(D), interpret=True))
    before = launch_counts()
    got = gf256_matmul(A, torch.from_numpy(D))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gf256_matmul_plain(A, torch.from_numpy(D)).numpy(), want)
    assert launch_counts() == before      # plain versions never count


@pytest.mark.parametrize("shape,zero_one", [((32, 128), True),
                                            ((12, 20), False)])
def test_single_matmul_above_the_unroll_rule(shape, zero_one):
    """Matrices the strategy rule sends to the 0/1 or column-loop body
    run as a batch of one; the reference's single-stripe entry takes
    them too (its CPU path, as its own tests run it)."""
    rng = _rng("mm-big", shape)
    A = ((rng.integers(0, 4, shape) == 0).astype(np.uint8) if zero_one
         else _u8(rng, shape))
    D = _u8(rng, (shape[1], 200))
    got = gf256_matmul(A, torch.from_numpy(D))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_gf256_matmul(A, jnp.asarray(D))))


@pytest.mark.parametrize("m,C", [(2, 4096), (4, 1000), (1, 128), (14, 999)])
def test_delta_update_plain_matches_pallas(m, C):
    rng = _rng("du", m, C)
    P, old, new = _u8(rng, (m, C)), _u8(rng, C), _u8(rng, C)
    G = rng.integers(0, 256, m).astype(np.int32)
    G[0] = 0                                        # a zero gamma row
    want = np.asarray(ref_delta_update(
        jnp.asarray(P), jnp.asarray(G), jnp.asarray(old), jnp.asarray(new),
        interpret=True))
    args = (torch.from_numpy(P), G, torch.from_numpy(old),
            torch.from_numpy(new))
    np.testing.assert_array_equal(delta_update(*args).numpy(), want)
    np.testing.assert_array_equal(delta_update_plain(*args).numpy(), want)
    # gammas as a tensor, and gammas above 255 (the kernel takes g & 255)
    np.testing.assert_array_equal(
        delta_update(args[0], torch.from_numpy(G + 512), *args[2:]).numpy(),
        want)


def _probe_inputs(rng, nbuckets, Q):
    """A random table and Q queries: half hit an occupied slot through
    h1's or h2's bucket, some with h1 == h2, the rest miss."""
    high = rng.integers(0, 2, (nbuckets, 4)).astype(np.uint64)
    fps = rng.integers(1, 2 ** 63, (nbuckets, 4)).astype(np.uint64) \
        | (high << np.uint64(63))
    occ = rng.random((nbuckets, 4)) < 0.8
    h1 = rng.integers(0, 2 ** 63, Q).astype(np.uint64)
    h2 = rng.integers(0, 2 ** 63, Q).astype(np.uint64)
    fp = rng.integers(1, 2 ** 63, Q).astype(np.uint64)
    h2[::7] = h1[::7]                               # b1 == b2
    occupied = np.flatnonzero(occ)
    for q in range(0, Q, 2):                        # hits
        b, s = divmod(int(rng.choice(occupied)), 4)
        fp[q] = fps[b, s]
        h = np.uint64(b + nbuckets * int(rng.integers(0, 1 << 20)))
        if q % 7 == 0:
            h1[q] = h2[q] = h
        elif q % 4:
            h1[q] = h
        else:
            h2[q] = h
    return fps, occ, h1, h2, fp


@pytest.mark.parametrize("nbuckets,Q", [(64, 1), (64, 40), (256, 120)])
def test_cuckoo_probe_plain_matches_pallas(nbuckets, Q):
    rng = _rng("probe", nbuckets, Q)
    args = _probe_inputs(rng, nbuckets, Q)
    rf, rs = ref_cuckoo_lookup(*args, interpret=True)
    found, slot = cuckoo_lookup(*args, device="cpu")
    np.testing.assert_array_equal(found.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rs))
    assert found[0] and (Q == 1 or not found.all())
    # the table as tensors (uint64 or int64) runs where it lies
    f2, s2 = cuckoo_lookup(torch.from_numpy(args[0]),
                           torch.from_numpy(args[1]), *args[2:])
    assert torch.equal(f2, found) and torch.equal(s2, slot)


def test_cuckoo_probe_rejects_bad_tables():
    fps = np.zeros((8, 4), np.uint64)
    with pytest.raises(ValueError):
        cuckoo_lookup(fps, np.zeros((8, 3), bool), [1], [2], [3],
                      device="cpu")
    with pytest.raises(ValueError):
        cuckoo_lookup(np.zeros((0, 4), np.uint64), np.zeros((0, 4), bool),
                      [1], [2], [3], device="cpu")
    with pytest.raises(ValueError):
        cuckoo_lookup(fps, np.zeros((8, 4), bool), [1, 2], [2], [3],
                      device="cpu")


# ---------------------------------------------------------------------------
# the kernels package under threads (the sharded cluster's scatter)
# ---------------------------------------------------------------------------

def _in_threads(fn, n=8):
    start = threading.Barrier(n)

    def run():
        start.wait()
        fn()
    threads = [threading.Thread(target=run) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_launch_counts_lose_nothing_across_threads():
    table = {"k": 0}
    _in_threads(lambda: [_build.count_launch(table, "k")
                         for _ in range(20_000)])
    assert table == {"k": 8 * 20_000}


def test_library_builds_once_across_threads(monkeypatch):
    calls = []
    barrier = threading.Event()

    def fake_build():
        calls.append(1)
        barrier.wait(0.2)        # hold the first build while others arrive
        return ctypes.util.find_library("c") or "libc.so.6"
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build, "SIGNATURES", {})
    monkeypatch.setattr(_build, "_LIBRARY", None)
    libs = []
    _in_threads(lambda: libs.append(_build.library()))
    assert len(calls) == 1 and len({id(lib) for lib in libs}) == 1


def test_device_caches_fill_once_across_threads():
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    A = np.eye(3, dtype=np.uint8)
    got = []
    _in_threads(lambda: got.append(gm._device_matrix(
        "gf01", A.tobytes(), A.shape, torch.device("cpu"))))
    assert len({id(t) for t in got}) == 1
