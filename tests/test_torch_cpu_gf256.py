"""``repro_torch.kernels.cpu_gf256`` against the JAX package's
``kernels/xla_gf256.py``, strategy by strategy, and against the plain
versions.

Every entry point (``matmul_batched``, ``matmul``, ``matmul_per_item``,
``delta_single``, ``delta_batched``) runs each of its strategies on the
same numpy inputs as the reference's function with the same strategy.
The matrices: RS(10,8) and RS(14,10) parity matrices and decode
inverses, RDP(10,8)'s 0/1 block matrix and its GF(2) decode inverse, a
matrix with an all-zero row and one with no rows; C 1, 100 and 4096
(ragged to the packed 4-byte lanes and not); B 0, 1, 3 and 16.

Every (B, C) of the grid meets the plain versions.  The reference
jit-compiles one program per shape (4 to 9 s for the RDP matrices'
1,024-step bit-plane unrolls), so it is met at ``REF``, five shapes that
take every B and every C once.  The two RDP matrices and the RDP
per-item systems run ``SLOW_GRID`` only (their plain versions gather
10^9 bytes at B 16 x C 4096), and meet the reference at B 3 x C 100.  Tolerance: exact equality
everywhere.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.kernels import xla_gf256 as ref
from repro_torch.core import gf256
from repro_torch.core.codes import RSCode, make_code
from repro_torch.core.engine import block_rep
from repro_torch.kernels import cpu_gf256 as cpu

du = importlib.import_module("repro_torch.kernels.delta_update")
gm = importlib.import_module("repro_torch.kernels.gf256_matmul")

torch.set_num_threads(1)

CS = (1, 100, 4096)
BS = (0, 1, 3, 16)
GRID = [(B, C) for B in BS for C in CS]
REF = {(0, 100), (1, 1), (1, 4096), (3, 100), (16, 4096)}
SLOW_GRID = [(0, 100), (3, 100), (1, 4096)]


def _inverse(code, erased=(0, 1)):
    """The (k*r, k*r) decode inverse of ``code`` with ``erased`` lost,
    as ``CodingEngine._decode_inverse`` builds it."""
    rep = block_rep(code)
    r = rep.r
    use = [p for p in range(code.n) if p not in erased][:code.k]
    rows = np.concatenate([rep.generator[p * r:(p + 1) * r] for p in use])
    return gf256.gf_mat_inv(rows)


def _matrices() -> dict:
    rs = np.asarray(RSCode(n=10, k=8).parity_matrix, np.uint8)
    zero_row = rs.copy()
    zero_row[1] = 0
    rdp = make_code("rdp", 10, 8)
    return {
        "rs10_8": rs,
        "rs10_8_inv": _inverse(RSCode(n=10, k=8)),
        "rs14_10": np.asarray(RSCode(n=14, k=10).parity_matrix, np.uint8),
        "rs14_10_inv": _inverse(RSCode(n=14, k=10), erased=(0, 3, 5, 7)),
        "rdp10_8": np.asarray(block_rep(rdp).encode, np.uint8),
        "rdp10_8_inv": _inverse(rdp),
        "zero_row": zero_row,
        "no_rows": np.zeros((0, 8), np.uint8),
    }


MATS = _matrices()
SLOW = ("rdp10_8", "rdp10_8_inv")


def _shapes(slow: bool) -> list:
    """(B, C, whether the reference runs it)."""
    if slow:
        return [(B, C, (B, C) == (3, 100)) for B, C in SLOW_GRID]
    return [(B, C, (B, C) in REF) for B, C in GRID]


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def test_grid_matrices_are_what_they_claim():
    assert MATS["rdp10_8"].shape == (32, 128) and MATS["rdp10_8"].max() == 1
    assert MATS["rdp10_8_inv"].shape == (128, 128)
    assert MATS["rdp10_8_inv"].max() == 1      # a GF(2) inverse
    assert MATS["rs10_8_inv"].max() > 1


@pytest.mark.parametrize("strategy", cpu.STRATEGIES)
@pytest.mark.parametrize("name", sorted(MATS))
def test_matmul_batched_equals_reference_and_plain(name, strategy):
    A = MATS[name]
    rng = np.random.default_rng(len(name))
    for B, C, with_ref in _shapes(name in SLOW):
        data = _u8(rng, B, A.shape[1], C)
        got = cpu.matmul_batched(A, torch.from_numpy(data), strategy=strategy)
        assert got.dtype == torch.uint8 and got.is_contiguous()
        plain = gm.gf256_matmul_batched_plain(A, torch.from_numpy(data))
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        if with_ref:
            want = np.asarray(ref.matmul_batched(A, data, strategy=strategy))
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("strategy", cpu.STRATEGIES)
@pytest.mark.parametrize("name", [n for n in sorted(MATS) if n not in SLOW])
def test_matmul_single_equals_reference(name, strategy):
    A = MATS[name]
    rng = np.random.default_rng(7)
    for C in CS:
        data = _u8(rng, A.shape[1], C)
        got = cpu.matmul(A, torch.from_numpy(data), strategy=strategy)
        want = np.asarray(ref.matmul(A, data, strategy=strategy))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), gm.gf256_matmul_plain(A, torch.from_numpy(data))
            .numpy())


def _per_item_mats(rng, kind, B):
    if kind == "rdp":       # RDP's (m*r, r) 0/1 per-item systems
        E4 = MATS["rdp10_8"].reshape(32, 8, 16)
        return np.ascontiguousarray(E4[:, rng.integers(0, 8, B), :]
                                    .transpose(1, 0, 2))
    if kind == "collapse":  # the RS hot-tier (m, 1) columns
        return np.ascontiguousarray(
            MATS["rs10_8"][:, rng.integers(0, 8, B)].T[:, :, None])
    Ms = rng.integers(0, 256, (B, 4, 3), dtype=np.uint8)
    if B:
        Ms[0, 2] = 0                                   # an empty row
    return Ms


@pytest.mark.parametrize("fold", (False, True))
@pytest.mark.parametrize("strategy", cpu.STRATEGIES)
@pytest.mark.parametrize("kind", ("rdp", "collapse", "dense"))
def test_matmul_per_item_equals_reference_and_plain(kind, strategy, fold):
    rng = np.random.default_rng(11)
    for B, C, with_ref in _shapes(kind == "rdp"):
        Ms = _per_item_mats(rng, kind, B)
        O, J = Ms.shape[1:]
        blocks = _u8(rng, B, J, C)
        parity = _u8(rng, B, O, C) if fold else None
        tp = torch.from_numpy(parity) if fold else None
        got = cpu.matmul_per_item(Ms, torch.from_numpy(blocks), tp,
                                  strategy=strategy)
        plain = gm.gf256_matmul_per_item_plain(Ms, torch.from_numpy(blocks),
                                               tp)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        if with_ref:
            want = np.asarray(ref.matmul_per_item(Ms, blocks, parity,
                                                  strategy=strategy))
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fold", (False, True))
@pytest.mark.parametrize("m", (0, 2, 4))
def test_delta_batched_equals_reference_and_plain(m, fold):
    rng = np.random.default_rng(m)
    for B, C, with_ref in _shapes(False):
        g = rng.integers(0, 256, (B, m))
        xor = _u8(rng, B, C)
        parity = _u8(rng, B, m, C) if fold else None
        tp = torch.from_numpy(parity) if fold else None
        got = cpu.delta_batched(g, torch.from_numpy(xor), tp)
        plain = du.delta_apply_batched_plain(tp, g, torch.from_numpy(xor))
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        if with_ref:
            want = np.asarray(ref.delta_batched(g, xor, parity))
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", (0, 2, 4))
def test_delta_single_equals_reference_and_plain(m):
    rng = np.random.default_rng(m + 5)
    for C in CS:
        parity, old, new = _u8(rng, m, C), _u8(rng, C), _u8(rng, C)
        g = rng.integers(0, 256, m)
        got = cpu.delta_single(torch.from_numpy(parity), g,
                               torch.from_numpy(old), torch.from_numpy(new))
        want = np.asarray(ref.delta_single(parity, g, old, new))
        np.testing.assert_array_equal(got.numpy(), want)
        plain = du.delta_update_plain(torch.from_numpy(parity), g,
                                      torch.from_numpy(old),
                                      torch.from_numpy(new))
        np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_default_strategy_is_the_reference_rule():
    for name, A in MATS.items():
        assert cpu.default_strategy(A) == ref.default_strategy(A), name
    assert cpu.STRATEGIES == ref.STRATEGIES


def test_cpu_wrappers_route_through_cpu_gf256(monkeypatch):
    """On a CPU tensor each GF(2^8) wrapper runs ``cpu_gf256``."""
    calls = []
    for fn in ("matmul_batched", "matmul", "matmul_per_item",
               "delta_batched", "delta_single"):
        orig = getattr(cpu, fn)

        def spy(*a, _orig=orig, _fn=fn, **kw):
            calls.append(_fn)
            return _orig(*a, **kw)
        monkeypatch.setattr(cpu, fn, spy)
    rng = np.random.default_rng(3)
    A = MATS["rs10_8"]
    gm.gf256_matmul_batched(A, torch.from_numpy(_u8(rng, 2, 8, 64)))
    gm.gf256_matmul(A, torch.from_numpy(_u8(rng, 8, 64)))
    gm.gf256_matmul_per_item_batched(rng.integers(0, 256, (2, 2, 3)),
                                     torch.from_numpy(_u8(rng, 2, 3, 64)))
    du.delta_apply_batched(None, rng.integers(0, 256, (2, 2)),
                           torch.from_numpy(_u8(rng, 2, 64)))
    du.delta_update(torch.from_numpy(_u8(rng, 2, 64)), [3, 7],
                    torch.from_numpy(_u8(rng, 64)),
                    torch.from_numpy(_u8(rng, 64)))
    # ``matmul`` runs ``matmul_batched`` on a batch of one
    assert list(dict.fromkeys(calls)) == [
        "matmul_batched", "matmul", "matmul_per_item", "delta_batched",
        "delta_single"]
