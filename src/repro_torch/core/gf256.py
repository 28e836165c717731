"""GF(2^8) arithmetic for erasure coding (MemEC §2), PyTorch port.

The field is GF(2^8) with the standard primitive polynomial
x^8 + x^4 + x^3 + x^2 + 1 (0x11D), the same field used by Reed-Solomon
deployments (ISA-L, jerasure).  Host-side (numpy) paths build tables and
invert small matrices; device-side (torch) paths do vectorized mul/matmul
on whatever device their tensors live on.

The numpy half is a copy of the JAX package's module (the tables must be
the same bytes).  The torch half is the table formulation: log/exp
lookups with ``long`` indices and an XOR fold over k, since torch has no
XOR reduction.  The hand-written CUDA kernels (``kernels/csrc``) gather
from the same tables in shared memory.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
ORDER = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """Return (exp, log) tables. exp has 512 entries to avoid mod-255."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[0:255]  # wraparound copies
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()
# Full 256x256 multiplication table (64KB) — handy for oracles and the
# one-hot/MXU formulation.
_a = np.arange(256)
MUL_TABLE = np.zeros((256, 256), dtype=np.uint8)
_nz = _a[1:]
MUL_TABLE[1:, 1:] = EXP_TABLE[(LOG_TABLE[_nz][:, None] + LOG_TABLE[_nz][None, :]) % 255]


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """(exp, log, flat mul) tables on ``device``, built once per device."""
    return (torch.from_numpy(EXP_TABLE).to(device),
            torch.from_numpy(LOG_TABLE.astype(np.int64)).to(device),
            torch.from_numpy(MUL_TABLE.reshape(-1)).to(device))


def device_tables(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Public accessor for the per-device (exp, log, flat mul) tables."""
    return _device_tables(torch.device(device))


# ---------------------------------------------------------------------------
# host (numpy) scalar/array ops — used by control plane + decode inversion
# ---------------------------------------------------------------------------

def gf_mul_np(a, b):
    """Elementwise GF(2^8) product of two uint8 numpy arrays/scalars."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = MUL_TABLE[a, b]
    return out


def gf_inv_np(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(EXP_TABLE[255 - LOG_TABLE[a]])


def gf_div_np(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_matmul_np(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product (XOR-accumulate) of uint8 matrices."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    assert A.shape[-1] == B.shape[0]
    out = np.zeros(A.shape[:-1] + B.shape[1:], dtype=np.uint8)
    for i in range(A.shape[-1]):
        out ^= MUL_TABLE[A[..., i, None], B[i]] if B.ndim > 1 else MUL_TABLE[A[..., i], B[i]]
    return out


def gf_mat_inv(M: np.ndarray) -> np.ndarray:
    """Invert a small square matrix over GF(2^8) by Gauss-Jordan."""
    M = np.array(M, dtype=np.uint8)
    n = M.shape[0]
    assert M.shape == (n, n)
    aug = np.concatenate([M, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r, col] != 0), None)
        if piv is None:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = MUL_TABLE[aug[col], gf_inv_np(int(aug[col, col]))]
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= MUL_TABLE[aug[r, col], aug[col]]
    return aug[:, n:]


gf_mat_inv_np = gf_mat_inv  # canonical name used elsewhere


# ---------------------------------------------------------------------------
# bit-plane lift: multiplication-by-c as an 8x8 GF(2) matrix
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def gf_mul_matrix(c: int) -> np.ndarray:
    """8x8 binary matrix M such that (c * x) bits = M @ x bits (GF(2)).

    Bit convention: bit j of a byte is (byte >> j) & 1 (LSB first).
    M[j, i] = bit j of (c * 2^i).
    """
    M = np.zeros((8, 8), dtype=np.uint8)
    for i in range(8):
        prod = int(MUL_TABLE[c, 1 << i])
        for j in range(8):
            M[j, i] = (prod >> j) & 1
    return M


def lift_matrix(A: np.ndarray) -> np.ndarray:
    """Lift an (m,k) GF(2^8) matrix to its (m,8,k,8) binary bit-plane form.

    out[r, j, i, b] = bit j of (A[r,i] * 2^b): the GF(2) matrix applied to
    input bit-planes b of operand i producing output bit-plane j of row r.
    """
    A = np.asarray(A, dtype=np.uint8)
    m, k = A.shape
    out = np.zeros((m, 8, k, 8), dtype=np.uint8)
    for r in range(m):
        for i in range(k):
            out[r, :, i, :] = gf_mul_matrix(int(A[r, i]))
    return out


# ---------------------------------------------------------------------------
# device (torch) ops — table formulation
# ---------------------------------------------------------------------------

def gf_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(2^8) product (uint8 in, uint8 out), table-based.

    ``a`` and ``b`` broadcast against each other; the result lies on
    ``b``'s device."""
    b = torch.as_tensor(b).to(torch.uint8)
    a = torch.as_tensor(a, device=b.device).to(torch.uint8)
    exp, log, _ = device_tables(b.device)
    prod = exp[(log[a.long()] + log[b.long()]) % 255]
    zero = (a == 0) | (b == 0)
    return torch.where(zero, torch.zeros_like(prod), prod)


def gf_scale(c, x: torch.Tensor) -> torch.Tensor:
    """Multiply every byte of x by scalar c."""
    c_t = torch.as_tensor(c, dtype=torch.uint8, device=x.device)
    return gf_mul(c_t.expand(x.shape), x)


def gf_matmul(A, B: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul: (m,k) x (k, ...) -> (m, ...) with XOR accumulation.

    Table-based torch formulation; k is expected to be small (<= 32), so
    the XOR fold is a Python loop of ``^=``.
    """
    B = torch.as_tensor(B).to(torch.uint8)
    A = torch.as_tensor(A, device=B.device).to(torch.uint8)
    m, k = A.shape
    out = None
    for i in range(k):
        term = gf_mul(A[:, i].reshape((m,) + (1,) * (B.ndim - 1)), B[i][None])
        out = term if out is None else out ^ term
    return out


def bytes_view(x: torch.Tensor) -> torch.Tensor:
    """Bit-cast any tensor to its raw uint8 byte view (flat)."""
    return x.contiguous().reshape(-1).view(torch.uint8).reshape(-1)


def from_bytes_view(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    """Inverse of bytes_view."""
    return b.contiguous().reshape(-1).view(dtype).reshape(shape)
