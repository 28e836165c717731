"""The CPU GF(2^8) data plane: the counterpart of the JAX package's
``kernels/xla_gf256.py``.

On a CPU tensor every GF(2^8) wrapper (``gf256_matmul``,
``delta_update``) runs here instead of its kernel: the reference's three
formulations, written in torch on CPU tensors, all byte-identical to each
other and to the plain versions (``tests/test_torch_cpu_gf256.py``), and
picked per shape by ``kernels/tune.py`` (``default_strategy`` when the
tuning cache has no entry):

* ``bitplane32``: four bytes packed in an int32 lane; coefficients are
  < 256, so ``((x >> b) & 0x01010101) * c`` scales all four byte lanes
  with no carry between them (the top lane's product wraps, which torch's
  int32 product does); 8 shift/and/mul/xor steps per input row.  The
  arithmetic shift of a negative lane fills only bits >= 32 - b, which the
  mask drops for b <= 7.
* ``select32``: 0/1 matrices (RDP blocks and their GF(2) inverses):
  gamma in {0, 1} makes gamma·x a select, one masked XOR per input row on
  the same packed lanes.
* ``table``: the log/exp gather, one gather row per input column.

Torch has no XOR reduction, so each formulation folds its rows with a
loop of ``^=``.  The entry points mirror the reference's
(``matmul_batched``, ``matmul``, ``matmul_per_item``, ``delta_single``,
``delta_batched``) and take uint8 CPU tensors (or arrays) and host
matrices.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import gf256

_LANES = 0x01010101  # bit b of each packed byte after >> b

# strategy names (the tuner's vocabulary for this path)
BITPLANE32 = "bitplane32"
SELECT32 = "select32"
TABLE = "table"
STRATEGIES = (BITPLANE32, SELECT32, TABLE)


def _as_u8(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.uint8 else x.to(torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))


def default_strategy(A: np.ndarray) -> str:
    """The reference's heuristic when no tuning entry exists: 0/1
    matrices select, dense ones run the packed bit-plane."""
    return SELECT32 if int(np.asarray(A).max(initial=0)) <= 1 else BITPLANE32


def _apow(A: np.ndarray) -> np.ndarray:
    """(m, k) -> (m, k, 8) int32: A[r, i] * 2^b over GF(2^8)/0x11D."""
    g = np.asarray(A, dtype=np.int64)
    out = np.empty(g.shape + (8,), dtype=np.int32)
    for b in range(8):
        out[..., b] = g
        g = ((g << 1) ^ np.where(g & 0x80, gf256.POLY, 0)) & 0xFF
    return out


@functools.lru_cache(maxsize=256)
def _mat(kind: str, shape: tuple, buf: bytes) -> torch.Tensor:
    """Matrix constants, cached by value: encode and decode matrices are
    few and reused every call."""
    A = np.frombuffer(buf, dtype=np.uint8).reshape(shape)
    if kind == "apow":
        return torch.from_numpy(_apow(A))
    if kind == "i32":
        return torch.from_numpy(A.astype(np.int32))
    return torch.from_numpy(A.copy())


def _xtime_powers(g: torch.Tensor) -> torch.Tensor:
    """(...) int32 gammas -> (..., 8) int32, out[..., b] = g * 2^b."""
    outs = []
    for _ in range(8):
        outs.append(g)
        g = ((g << 1) ^ ((g >> 7) & 1) * gf256.POLY) & 0xFF
    return torch.stack(outs, dim=-1)


def _pad4(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pad the trailing byte axis to a multiple of 4; (padded, C)."""
    C = x.shape[-1]
    pad = (-C) % 4
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, C


def _pack32(x: torch.Tensor) -> torch.Tensor:
    """(..., C) uint8 -> (..., C // 4) int32 lanes (C % 4 == 0)."""
    return x.contiguous().view(torch.int32)


def _unpack32(x: torch.Tensor, C: int) -> torch.Tensor:
    out = x.view(torch.uint8)
    return out if out.shape[-1] == C else out[..., :C].contiguous()


def _tables():
    exp, log, _ = gf256.device_tables("cpu")
    return exp, log


def _table_prod(lc: torch.Tensor, c_zero: torch.Tensor, d: torch.Tensor,
                exp, log) -> torch.Tensor:
    """Products of coefficients (log ``lc``, zero mask ``c_zero``) and
    bytes ``d``, broadcast together: exp[(log c + log d) % 255], 0 where
    either is 0."""
    prod = exp[(lc + log[d.long()]) % 255]
    return prod.masked_fill_(c_zero | (d == 0), 0)


# ---------------------------------------------------------------------------
# shared-matrix batched matmul: (m, k) x (B, k, C) -> (B, m, C)
# ---------------------------------------------------------------------------

def _matmul_bitplane32(apow, d, m, k):
    B, _, C4 = d.shape
    acc = torch.zeros((B, m, C4), dtype=torch.int32)
    for j in range(k):
        dj = d[:, j]
        for b in range(8):
            bit = (dj >> b) & _LANES                      # (B, C/4)
            acc ^= bit[:, None, :] * apow[None, :, j, b, None]
    return acc


def _matmul_select32(a01, d, m, k):
    B, _, C4 = d.shape
    acc = torch.zeros((B, m, C4), dtype=torch.int32)
    for j in range(k):
        acc ^= a01[None, :, j, None] * d[:, j][:, None, :]
    return acc


def _matmul_table(A, data, m, k):
    exp, log = _tables()
    la = log[A.long()]                                    # (m, k)
    B, _, C = data.shape
    acc = torch.zeros((B, m, C), dtype=torch.uint8)
    for j in range(k):
        acc ^= _table_prod(la[None, :, j, None], (A[:, j] == 0)[None, :, None],
                           data[:, j][:, None, :], exp, log)
    return acc


def _resolve(strategy: str | None, A: np.ndarray) -> str:
    if strategy not in STRATEGIES or (strategy == SELECT32
                                      and int(A.max(initial=0)) > 1):
        return default_strategy(A)
    return strategy


def matmul_batched(A, data, *, strategy: str | None = None) -> torch.Tensor:
    """(m, k) host matrix x (B, k, C) uint8 -> (B, m, C)."""
    A = np.ascontiguousarray(A, dtype=np.uint8)
    m, k = A.shape
    data = _as_u8(data)
    B, kd, C = data.shape
    if kd != k:
        raise ValueError(f"data {tuple(data.shape)} does not match A {(m, k)}")
    if B == 0 or m == 0:
        return torch.zeros((B, m, C), dtype=torch.uint8)
    strategy = _resolve(strategy, A)
    raw = A.tobytes()
    if strategy == TABLE:
        return _matmul_table(_mat("u8", A.shape, raw), data, m, k)
    data, C = _pad4(data)
    d = _pack32(data)
    if strategy == SELECT32:
        acc = _matmul_select32(_mat("i32", A.shape, raw), d, m, k)
    else:
        acc = _matmul_bitplane32(_mat("apow", A.shape, raw), d, m, k)
    return _unpack32(acc, C)


def matmul(A, data, *, strategy: str | None = None) -> torch.Tensor:
    """(m, k) host matrix x (k, C) uint8 -> (m, C): the batched product
    on a batch of one."""
    data = _as_u8(data)
    if data.dim() != 2:
        raise ValueError("data must be (k, C)")
    return matmul_batched(A, data[None], strategy=strategy)[0]


# ---------------------------------------------------------------------------
# per-item-matrix batched matmul: (B, O, J) x (B, J, C) -> (B, O, C)
# ---------------------------------------------------------------------------

def matmul_per_item(Ms, blocks, parity=None, *,
                    strategy: str | None = None) -> torch.Tensor:
    """Per-item matrices: (B, O, J) x (B, J, C) -> (B, O, C), with
    ``parity`` (B, O, C) XORed in when given."""
    Ms = np.ascontiguousarray(Ms, dtype=np.uint8)
    blocks = _as_u8(blocks)
    B, O, J = Ms.shape
    C = blocks.shape[2]
    if tuple(blocks.shape[:2]) != (B, J):
        raise ValueError(f"blocks {tuple(blocks.shape)} vs Ms {(B, O, J)}")
    if B == 0 or O == 0:
        return torch.zeros((B, O, C), dtype=torch.uint8)
    strategy = _resolve(strategy, Ms)
    Mt = torch.from_numpy(Ms)
    if strategy == TABLE:
        exp, log = _tables()
        lm = log[Mt.long()]                               # (B, O, J)
        acc = (_as_u8(parity).clone() if parity is not None
               else torch.zeros((B, O, C), dtype=torch.uint8))
        for jj in range(J):
            acc ^= _table_prod(lm[:, :, jj, None], (Mt[:, :, jj] == 0)[..., None],
                               blocks[:, jj][:, None, :], exp, log)
        return acc
    blocks, C = _pad4(blocks)
    d = _pack32(blocks)
    C4 = d.shape[-1]
    acc = torch.zeros((B, O, C4), dtype=torch.int32)
    if strategy == SELECT32:
        m01 = Mt.to(torch.int32)
        for jj in range(J):
            acc ^= m01[:, :, jj, None] * d[:, jj][:, None, :]
    else:
        apow = _xtime_powers(Mt.to(torch.int32))          # (B, O, J, 8)
        for jj in range(J):
            dj = d[:, jj]
            for b in range(8):
                acc ^= ((dj >> b) & _LANES)[:, None, :] \
                    * apow[:, :, jj, b, None]
    if parity is not None:
        acc ^= _pack32(_pad4(_as_u8(parity))[0])
    return _unpack32(acc, C)


# ---------------------------------------------------------------------------
# per-item-gamma delta: gammas (B, m), xor (B, C) -> (B, m, C)
# ---------------------------------------------------------------------------

def _delta_lanes(gpow: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """gpow (..., m, 8) int32 powers, x (..., C/4) int32 lanes ->
    (..., m, C/4) lanes of gamma · x."""
    acc = torch.zeros(gpow.shape[:-1] + x.shape[-1:], dtype=torch.int32)
    for b in range(8):
        acc ^= ((x >> b) & _LANES)[..., None, :] * gpow[..., b, None]
    return acc


def _gammas(gammas) -> torch.Tensor:
    g = torch.as_tensor(np.asarray(gammas) if not isinstance(
        gammas, torch.Tensor) else gammas)
    return (g.to(torch.int64) & 255).to(torch.int32)


def delta_single(parity, gammas, old, new) -> torch.Tensor:
    """One stripe: parity (m, C) ^ gammas[r] · (old ^ new)."""
    parity = _as_u8(parity)
    m, C = parity.shape
    if m == 0:
        return parity.clone()
    x = _pack32(_pad4(_as_u8(old) ^ _as_u8(new))[0])
    acc = _delta_lanes(_xtime_powers(_gammas(gammas)), x)
    acc ^= _pack32(_pad4(parity)[0])
    return _unpack32(acc, C)


def delta_batched(gammas, xors, parity=None) -> torch.Tensor:
    """(B, m) gammas x (B, C) xors -> (B, m, C) deltas, XORed into
    ``parity`` (B, m, C) when given."""
    xors = _as_u8(xors)
    g = _gammas(gammas)
    B, m = g.shape
    C = xors.shape[1]
    if B == 0 or m == 0:
        return (_as_u8(parity).clone() if parity is not None
                else torch.zeros((B, m, C), dtype=torch.uint8))
    acc = _delta_lanes(_xtime_powers(g), _pack32(_pad4(xors)[0]))
    if parity is not None:
        acc ^= _pack32(_pad4(_as_u8(parity))[0])
    return _unpack32(acc, C)
