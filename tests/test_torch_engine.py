"""The port's coding engines against the JAX package's NumpyEngine.

Port engines: ``NumpyEngine``, ``TorchEngine(device="cpu")`` (plain torch
ops) and ``CudaEngine(device="cpu")`` (the kernel wrappers' CPU
dispatch).  Each op gets identical inputs on the reference
``repro.core.engine.NumpyEngine`` and must return the same bytes.
Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

from repro.core.codes import make_code as ref_make_code
from repro.core.engine import NumpyEngine as RefNumpyEngine
from repro_torch.core import engine as eng_mod
from repro_torch.core.codes import make_code
from repro_torch.core.engine import (CudaEngine, NumpyEngine, TorchEngine,
                                     make_engine)

torch.set_num_threads(1)

CODES = [("rs", 10, 8), ("rs", 6, 4), ("xor", 5, 4), ("rdp", 10, 8),
         ("rdp", 6, 4)]
ENGINES = ["numpy", "torch", "cuda"]
C = 1000


def width(code):
    """Chunk width of the grid: C for r = 1 codes; for RDP a multiple of
    r whose sub-block rows (63 bytes) take the kernels' byte path."""
    r = eng_mod.block_rep(code).r
    return C if r == 1 else 63 * r


def build(kind, code):
    if kind == "numpy":
        return NumpyEngine(code)
    if kind == "torch":
        return TorchEngine(code, device="cpu")
    return CudaEngine(code, device="cpu")


def pair(kind, scheme, n, k):
    return build(kind, make_code(scheme, n, k)), \
        RefNumpyEngine(ref_make_code(scheme, n, k))


def stripes(code, B, rng):
    data = rng.integers(0, 256, (B, code.k, width(code)), dtype=np.uint8)
    par = np.zeros((B, code.m, width(code)), np.uint8)
    for b in range(B):
        par[b] = code.encode(data[b])
    return data, par


def assert_decoded_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for p in g:
            np.testing.assert_array_equal(g[p], w[p])


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("scheme,n,k", CODES)
@pytest.mark.parametrize("B", [0, 1, 5])
def test_encode(kind, scheme, n, k, B):
    eng, ref = pair(kind, scheme, n, k)
    rng = np.random.default_rng(B * 31 + n)
    data = rng.integers(0, 256, (B, k, width(eng.code)), dtype=np.uint8)
    want = ref.encode_batch(data)
    np.testing.assert_array_equal(eng.encode_batch(data), want)
    np.testing.assert_array_equal(eng.submit_encode(data).result(), want)


def _erasure_batch(code, rng, B):
    """Mixed patterns in one batch: single and double erasures, data and
    parity positions wanted."""
    n, k, m = code.n, code.k, code.m
    data, par = stripes(code, B, rng)
    patterns = [((0,), (0,)), ((k - 1,), (k - 1,)), ((k,), (k,)),
                ((n - 1,), (0, n - 1))]
    if m >= 2:
        patterns += [((0, 1), (0, 1)), ((1, k), (1, k)), ((2, n - 1), (2,))]
    avail, wanted = [], []
    for b in range(B):
        lost, want = patterns[b % len(patterns)]
        stripe = np.concatenate([data[b], par[b]])
        avail.append({p: stripe[p] for p in range(n) if p not in lost})
        wanted.append(list(want))
    return avail, wanted


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("scheme,n,k", CODES)
def test_decode_mixed_patterns(kind, scheme, n, k):
    eng, ref = pair(kind, scheme, n, k)
    avail, wanted = _erasure_batch(eng.code, np.random.default_rng(n), 14)
    w = width(eng.code)
    want = ref.decode_batch(avail, wanted, w)
    assert_decoded_equal(eng.decode_batch(avail, wanted, w), want)
    assert_decoded_equal(eng.submit_decode(avail, wanted, w).result(), want)
    assert eng.decode_patterns_submitted >= len(
        {(tuple(sorted(a)), tuple(w)) for a, w in zip(avail, wanted)})


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("scheme,n,k", CODES)
@pytest.mark.parametrize("B", [0, 1, 6])
def test_delta_and_apply_delta(kind, scheme, n, k, B):
    eng, ref = pair(kind, scheme, n, k)
    rng = np.random.default_rng(B + 100 * n)
    idx = rng.integers(0, k, B)
    xors = rng.integers(0, 256, (B, width(eng.code)), dtype=np.uint8)
    _, par = stripes(eng.code, B, rng)
    want = ref.delta_batch(idx, xors)
    np.testing.assert_array_equal(eng.delta_batch(idx, xors), want)
    np.testing.assert_array_equal(eng.submit_delta(idx, xors).result(), want)
    want = ref.apply_delta_batch(par, idx, xors)
    np.testing.assert_array_equal(eng.apply_delta_batch(par, idx, xors), want)
    np.testing.assert_array_equal(
        eng.submit_apply_delta(par, idx, xors).result(), want)
    np.testing.assert_array_equal(
        eng.submit_apply_delta(par, idx, xors).result(),
        ref.submit_apply_delta(par, idx, xors).result())


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("scheme,n,k", CODES)
def test_fold_rows(kind, scheme, n, k):
    eng, ref = pair(kind, scheme, n, k)
    rng = np.random.default_rng(7 * n)
    B = 9
    idx = rng.integers(0, k, B)
    rows = rng.integers(0, eng.code.m, B)
    xors = rng.integers(0, 256, (B, width(eng.code)), dtype=np.uint8)
    prow = rng.integers(0, 256, (B, width(eng.code)), dtype=np.uint8)
    got = eng.submit_fold_rows(idx, xors, rows, prow)
    want = ref.submit_fold_rows(idx, xors, rows, prow)
    assert got.work_bytes == want.work_bytes and got.kind == want.kind
    np.testing.assert_array_equal(got.result(), want.result())


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("scheme,n,k", CODES)
def test_delta_collapse(kind, scheme, n, k):
    """Versions per item: 1-8 each; none for any item (the XOR of no
    version is zero, so the parity comes back unchanged); and some items
    with none beside items with several."""
    eng, ref = pair(kind, scheme, n, k)
    rng = np.random.default_rng(11 * n)
    for counts in ((1, 3, 2, 8, 1), (0, 0), (0, 2, 0, 1)):
        B = len(counts)
        idx = rng.integers(0, k, B)
        versions = [rng.integers(0, 256, (v, width(eng.code)),
                                 dtype=np.uint8) for v in counts]
        _, par = stripes(eng.code, B, rng)
        got = eng.submit_delta_collapse(par, idx, versions)
        want = ref.submit_delta_collapse(par, idx, versions)
        assert got.work_bytes == want.work_bytes
        np.testing.assert_array_equal(got.result(), want.result())
        if not any(counts):
            np.testing.assert_array_equal(got.result(), par)


@pytest.mark.parametrize("scheme,n,k", [("rdp", 6, 4)])
@pytest.mark.parametrize("kind", ENGINES)
def test_rdp_on_the_engines_that_take_it(kind, scheme, n, k):
    eng, ref = pair(kind, scheme, n, k)
    r = eng.rep.r
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (3, k, 16 * r), dtype=np.uint8)
    np.testing.assert_array_equal(eng.encode_batch(data),
                                  ref.encode_batch(data))
    idx = np.array([0, 3, 1])
    xors = rng.integers(0, 256, (3, 16 * r), dtype=np.uint8)
    np.testing.assert_array_equal(eng.delta_batch(idx, xors),
                                  ref.delta_batch(idx, xors))


@pytest.mark.parametrize("kind", ENGINES)
def test_rs_14_10_decodes_reach_the_column_loop(kind):
    """RS(14,10), the f4 warm-store code: decodes that re-encode three or
    four parities build fused matrices of (13, 10) and (14, 10), above
    the unroll limit, so the device engines run the ``cols`` body."""
    from repro_torch.kernels.gf256_matmul import choose_strategy
    eng, ref = pair(kind, "rs", 14, 10)
    rng = np.random.default_rng(1410)
    data, par = stripes(eng.code, 12, rng)
    patterns = [((0,), (0, 10, 11, 12)), ((0, 1, 2), (1, 11, 12, 13)),
                ((3,), (3, 10, 11, 12, 13)), ((10, 11, 12, 13), (10, 11, 12)),
                ((5, 9), (5,))]
    avail, wanted = [], []
    for b in range(len(data)):
        lost, want = patterns[b % len(patterns)]
        stripe = np.concatenate([data[b], par[b]])
        avail.append({p: stripe[p] for p in range(14) if p not in lost})
        wanted.append(list(want))
    want = ref.decode_batch(avail, wanted, C)
    assert_decoded_equal(eng.decode_batch(avail, wanted, C), want)
    if kind != "numpy":
        shapes = {M.shape: choose_strategy(M)
                  for M in eng._fused_cache.values()}
        assert shapes[(13, 10)] == shapes[(14, 10)] == "cols", shapes
        assert shapes[(10, 10)] == "unroll", shapes


def test_cuda_engine_rdp_takes_the_per_item_path():
    """r > 1: deltas and sealed updates go through the per-item kernels
    (``delta_per_item``), never the r = 1 gamma kernel (``delta``)."""
    eng = build("cuda", make_code("rdp", 10, 8))
    rng = np.random.default_rng(108)
    xors = rng.integers(0, 256, (4, 256), dtype=np.uint8)
    par = rng.integers(0, 256, (4, 2, 256), dtype=np.uint8)
    eng.submit_delta(np.arange(4), xors).result()
    eng.submit_apply_delta(par, np.arange(4), xors).result()
    assert eng.op_paths == {"delta_per_item": "torch-cpu"}


# ---------------------------------------------------------------------------
# probes: dispatch at submit, provenance, selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,path", [("torch", "torch-plain"),
                                       ("cuda", "torch-cpu")])
def test_device_engines_dispatch_at_submit(kind, path):
    eng = build(kind, make_code("rs", 10, 8))
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (4, 8, C), dtype=np.uint8)
    fut = eng.submit_encode(data)
    assert eng.device_dispatches == 1 and not fut.done
    avail, wanted = _erasure_batch(eng.code, rng, 7)
    n_groups = len({(tuple(sorted(a)), tuple(w))
                    for a, w in zip(avail, wanted)})
    dfut = eng.submit_decode(avail, wanted, C)
    assert eng.device_dispatches == 1 + n_groups and not dfut.done
    xors = rng.integers(0, 256, (4, C), dtype=np.uint8)
    eng.submit_delta(np.arange(4), xors)
    eng.submit_fold_rows(np.arange(4), xors, np.zeros(4, int), xors)
    assert eng.device_dispatches == 3 + n_groups
    fut.result(), dfut.result()
    assert set(eng.op_paths.values()) == {path}
    want_ops = {"matmul", "delta_per_item"} | (
        {"delta"} if kind == "cuda" else set())
    assert set(eng.op_paths) == want_ops
    d, s = eng.describe(), eng.stats()
    assert d["engine"] == kind and d["device"] == "cpu"
    assert d["path"] == ("torch-plain" if kind == "torch" else "torch-cpu")
    assert s["device_dispatches"] == eng.device_dispatches
    assert s["op_paths"] == eng.op_paths and s["inv_cache"] > 0


def test_numpy_engine_never_dispatches():
    eng = NumpyEngine(make_code("rs", 10, 8))
    rng = np.random.default_rng(4)
    eng.submit_encode(rng.integers(0, 256, (2, 8, C), dtype=np.uint8)).result()
    assert eng.device_dispatches == 0 and eng.op_paths == {}
    assert eng.describe()["path"] == "numpy-host"


def test_make_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.delenv("MEMEC_TORCH_ENGINE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = make_code("rs", 10, 8)
    for name in (None, "cuda", "torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_engine(name, code)


def test_make_engine_names_and_env(monkeypatch):
    code = make_code("rs", 10, 8)
    monkeypatch.setenv("MEMEC_ENGINE", "pallas")   # the reference's knob
    monkeypatch.setenv("MEMEC_TORCH_ENGINE", "torch:cpu")
    eng = make_engine(None, code)
    assert type(eng) is TorchEngine and eng.device == torch.device("cpu")
    assert type(make_engine("numpy", code)) is NumpyEngine
    assert type(make_engine("NumPy,cuda", code)) is NumpyEngine
    inst = NumpyEngine(code)
    assert make_engine(inst, code) is inst
    for bad in ("pallas", "jax", "numpy:cpu"):
        with pytest.raises(ValueError):
            make_engine(bad, code)
    assert set(eng_mod.ENGINES) == {"numpy", "torch", "cuda"}
