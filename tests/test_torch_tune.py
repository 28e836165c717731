"""``repro_torch.kernels.tune``: the port of the reference's tuning-cache
tests (``tests/test_dispatch_tune.py``) under ``$MEMEC_TORCH_TUNE_CACHE``,
and the lookups that steer the wrappers.

Round trip, a corrupt or missing cache, malformed entries and the
committed defaults behave as in the reference; a tuned entry steers the
CPU formulation (seen by a spy) and the card's per-item coefficient
form; the reference's ``$MEMEC_TUNE_CACHE`` has no effect on the port.
The outputs stay byte-identical whatever the cache says.
"""
import importlib
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import gf256
from repro_torch.core.codes import RSCode
from repro_torch.kernels import coefs, cpu_gf256, dispatch, tune

gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
du = importlib.import_module("repro_torch.kernels.delta_update")

torch.set_num_threads(1)

RS = np.asarray(RSCode(n=10, k=8).parity_matrix, np.uint8)


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tune.ENV, str(path))
    monkeypatch.delenv("MEMEC_TUNE_CACHE", raising=False)
    yield path
    monkeypatch.delenv(tune.ENV)
    tune.load_cache(reload=True)


def _write(path, entries):
    path.write_text(json.dumps({"version": 1, "entries": entries}))
    tune.load_cache(reload=True)


def test_tune_cache_round_trip(cache_file):
    # a pointed-at-but-missing cache warns once and degrades to empty
    with pytest.warns(UserWarning, match="not found"):
        assert tune.load_cache(reload=True) == {}
    A = np.asarray(RSCode(n=6, k=4).parity_matrix, np.uint8)
    best = tune.autotune_matmul(A, chunk=64, batch=2, device="cpu", reps=1)
    assert best["strategy"] in cpu_gf256.STRATEGIES and best["block_c"] == 0
    assert tune.save() == str(cache_file)
    tune.load_cache(reload=True)
    ent = tune.lookup("matmul", dispatch.TORCH_CPU, k=4, m=2, chunk=64,
                      batch=2, cls=tune.matrix_cls(A))
    assert ent is not None and ent["strategy"] == best["strategy"]
    raw = json.loads(cache_file.read_text())
    assert raw["version"] == 1 and raw["entries"] and raw["host"]
    assert list(raw["entries"]) == ["matmul/torch-cpu/gf/k4m2c64b2"]


@pytest.mark.parametrize("content", (None, "not json {", '{"entries": 3}',
                                     '["wrong shape"]'))
def test_corrupt_or_missing_cache_falls_back(cache_file, content):
    if content is not None:
        cache_file.write_text(content)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cache = tune.load_cache(reload=True)
    assert cache == {}
    assert not tune.active("matmul", dispatch.TORCH_CPU)
    # dispatch still answers correctly with heuristics only
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (2, 8, 100), dtype=np.uint8)
    want = np.stack([gf256.gf_matmul_np(RS, d) for d in data])
    got = gm.gf256_matmul_batched(RS, torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)


def test_malformed_entries_are_filtered(cache_file):
    key = tune.key("matmul", dispatch.TORCH_CPU, k=8, m=2, chunk=64,
                   batch=1)
    cache_file.write_text(json.dumps({"entries": {
        key: {"strategy": "bitplane32", "block_c": 0},
        "bad/one": {"block_c": 9},                      # no strategy
        "worse/one": "not a dict",
    }}))
    cache = tune.load_cache(reload=True)
    assert list(cache) == [key]
    assert tune.active("matmul", dispatch.TORCH_CPU)
    assert not tune.active("matmul", dispatch.CUDA)


def test_committed_defaults_parse():
    """The committed defaults load cleanly and hold CPU entries only, so
    the card keeps its built-in rule."""
    raw = json.loads(open(tune.DEFAULTS_PATH).read())
    assert raw["entries"], "committed tune defaults are empty"
    assert raw["host"]
    for k, v in raw["entries"].items():
        assert "strategy" in v and "block_c" in v, k
        assert k.split("/")[1] == dispatch.TORCH_CPU, k
        assert v["strategy"] in cpu_gf256.STRATEGIES, k
    matmul, per_item = tune.ci_shapes()
    assert len(raw["entries"]) == len(matmul) + len(per_item)


def _spy(monkeypatch, names):
    seen = []
    for name in names:
        orig = getattr(cpu_gf256, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(cpu_gf256, name, spy)
    return seen


@pytest.mark.parametrize("strategy,body", (("table", "_matmul_table"),
                                           ("bitplane32",
                                            "_matmul_bitplane32")))
def test_tuned_entry_steers_cpu_matmul(cache_file, monkeypatch, strategy,
                                       body):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (3, 8, 64), dtype=np.uint8)
    want = gm.gf256_matmul_batched_plain(RS, torch.from_numpy(data))
    _write(cache_file, {
        tune.key("matmul", dispatch.TORCH_CPU, k=8, m=2, chunk=64, batch=3):
            {"strategy": strategy, "block_c": 0},
        tune.key("matmul", dispatch.TORCH_CPU, k=8, m=2, chunk=64, batch=1):
            {"strategy": strategy, "block_c": 0}})
    seen = _spy(monkeypatch, ("_matmul_table", "_matmul_bitplane32"))
    got = gm.gf256_matmul_batched(RS, torch.from_numpy(data))
    got1 = gm.gf256_matmul(RS, torch.from_numpy(data[0]))
    assert seen == [body, body]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got1.numpy(), want[0].numpy())
    # a named strategy still wins; another shape keeps the default rule
    seen.clear()
    other = "bitplane32" if strategy == "table" else "table"
    gm.gf256_matmul_batched(RS, torch.from_numpy(data), strategy=other)
    gm.gf256_matmul_batched(RS, torch.from_numpy(data[:2]))
    assert seen == [{"table": "_matmul_table",
                     "bitplane32": "_matmul_bitplane32"}[other],
                    "_matmul_bitplane32"]


def test_tuned_entry_steers_cpu_delta_per_item(cache_file, monkeypatch):
    rng = np.random.default_rng(2)
    Ms = rng.integers(0, 256, (4, 2, 1), dtype=np.uint8)
    blocks = torch.from_numpy(rng.integers(0, 256, (4, 1, 64),
                                           dtype=np.uint8))
    parity = torch.from_numpy(rng.integers(0, 256, (4, 2, 64),
                                           dtype=np.uint8))
    want = gm.gf256_matmul_per_item_plain(Ms, blocks, parity)
    _write(cache_file, {tune.key("delta_per_item", dispatch.TORCH_CPU, k=1,
                                 m=2, chunk=64, batch=4):
                        {"strategy": "table", "block_c": 0}})
    seen = _spy(monkeypatch, ("_table_prod",))
    got = du.delta_apply_per_item_batched(parity, Ms, blocks)
    assert seen == ["_table_prod"]          # one input column, J = 1
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_reference_env_var_has_no_effect(tmp_path, monkeypatch):
    """``$MEMEC_TUNE_CACHE`` names the reference's cache, never the
    port's: an entry there steers nothing here."""
    path = tmp_path / "ref.json"
    path.write_text(json.dumps({"entries": {
        tune.key("matmul", dispatch.TORCH_CPU, k=8, m=2, chunk=64, batch=3):
            {"strategy": "table", "block_c": 0}}}))
    monkeypatch.delenv(tune.ENV, raising=False)
    monkeypatch.setenv("MEMEC_TUNE_CACHE", str(path))
    assert tune.cache_path() == tune.DEFAULTS_PATH
    tune.load_cache(reload=True)
    seen = _spy(monkeypatch, ("_matmul_table", "_matmul_bitplane32"))
    data = np.random.default_rng(3).integers(0, 256, (3, 8, 64),
                                             dtype=np.uint8)
    gm.gf256_matmul_batched(RS, torch.from_numpy(data))
    assert seen == ["_matmul_bitplane32"]


def test_per_item_form_follows_the_strategy():
    """On the card a per-item batch travels as row masks (the ``gf01``
    form, the default for 0/1 matrices with J <= 32) or as bytes
    (``cols``)."""
    M01 = np.random.default_rng(4).integers(0, 2, (3, 32, 16),
                                            dtype=np.uint8)
    mb, host = gm.per_item_host(M01, None)
    assert mb == 2 and host.nbytes == 3 * 32 * 2
    assert gm.per_item_host(M01, "gf01")[0] == 2
    mb, host = gm.per_item_host(M01, "cols")
    assert mb == 0 and np.array_equal(host, M01)
    dense = np.full((3, 2, 1), 7, np.uint8)
    assert gm.per_item_host(dense, "gf01") == coefs.per_item_coefs(dense)
    assert tune.candidates("delta_per_item", dispatch.CUDA, m=32, k=16,
                           is01=True) == [{"strategy": "cols", "block_c": 0},
                                          {"strategy": "gf01", "block_c": 0}]
    assert tune.candidates("delta_per_item", dispatch.CUDA, m=2, k=1,
                           is01=False) == [{"strategy": "cols",
                                            "block_c": 0}]
    assert tune.candidates("matmul", dispatch.TORCH_CPU, m=2, k=8,
                           is01=False) == [
        {"strategy": "bitplane32", "block_c": 0},
        {"strategy": "table", "block_c": 0}]


def test_concurrent_records_and_lookups(cache_file):
    """Threads recording and looking up at once lose no entry."""
    tune.load_cache(reload=True)
    errors = []

    def work(t):
        try:
            for i in range(50):
                k = tune.key("matmul", dispatch.TORCH_CPU, k=t, m=i,
                             chunk=1, batch=1)
                tune.record(k, {"strategy": "table", "block_c": 0})
                assert tune.load_cache()[k]["strategy"] == "table"
                assert tune.active("matmul", dispatch.TORCH_CPU)
        except Exception as e:        # noqa: BLE001 - reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(tune.load_cache()) == 16 * 50


def test_probe_follows_the_env_var_without_a_reload(tmp_path, monkeypatch):
    """``active``, the wrappers' cheap probe, sees ``$MEMEC_TORCH_TUNE_CACHE``
    move to another file and back with no ``load_cache`` call between, as
    the reference's lookup does; so does the wrapper's strategy."""
    A = RS[:2]
    key = tune.key("matmul", dispatch.CUDA, k=8, m=2, chunk=4096, batch=1,
                   cls=tune.matrix_cls(A))
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"version": 1, "entries": {
        key: {"strategy": "cols", "block_c": 0}}}))
    monkeypatch.delenv(tune.ENV, raising=False)
    tune.load_cache(reload=True)
    assert not tune.active("matmul", dispatch.CUDA)
    monkeypatch.setenv(tune.ENV, str(path))
    assert tune.active("matmul", dispatch.CUDA)
    assert gm._tuned("matmul", dispatch.CUDA, A, chunk=4096,
                     batch=1) == "cols"
    monkeypatch.delenv(tune.ENV)
    assert not tune.active("matmul", dispatch.CUDA)
    assert gm._tuned("matmul", dispatch.CUDA, A, chunk=4096,
                     batch=1) is None
    tune.load_cache(reload=True)
