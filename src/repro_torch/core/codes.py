"""Erasure codes for MemEC: Reed-Solomon (Cauchy), RDP, and single-XOR.

All codes are systematic: a stripe is ``n`` chunks = ``k`` data chunks
followed by ``m = n - k`` parity chunks.  MDS codes recover the stripe from
any ``k`` of the ``n`` chunks.

This module is the *host* (numpy) data plane used by the in-process cluster
simulation — the paper's C++ servers run coding on CPU too.  The TPU data
plane lives in ``repro.kernels`` (Pallas) and ``repro.distributed``
(shard_map collectives); both are validated against this module.

Delta parity updates exploit linearity (paper §2):

    P_j' = P_j  ⊕  gamma_{j,i} · (D_i' ⊕ D_i)
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import gf256


class Code:
    """Interface shared by RS / RDP / XOR / NoCode."""

    n: int
    k: int

    @property
    def m(self) -> int:
        return self.n - self.k

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data: (k, C) uint8 -> parity (m, C) uint8."""
        raise NotImplementedError

    def decode(self, available: dict[int, np.ndarray], wanted: list[int],
               chunk_size: int) -> dict[int, np.ndarray]:
        """Reconstruct stripe positions ``wanted`` from ``available``."""
        raise NotImplementedError

    def xor_delta(self, data_index: int, xor: np.ndarray) -> np.ndarray:
        """Parity deltas (m, C) for data chunk ``data_index`` changing by
        ``xor`` = D ⊕ D' (full chunk width; sparse updates are zero-padded).
        Apply with ``parity ^= delta[j]``.
        """
        raise NotImplementedError

    def parity_delta(self, data_index: int, old: np.ndarray, new: np.ndarray) -> np.ndarray:
        old = np.asarray(old, dtype=np.uint8)
        new = np.asarray(new, dtype=np.uint8)
        return self.xor_delta(data_index, old ^ new)


# ---------------------------------------------------------------------------
# Reed-Solomon (systematic Cauchy construction — always MDS)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cauchy_parity(n: int, k: int) -> np.ndarray:
    if n > 256:
        raise ValueError("RS over GF(2^8) requires n <= 256")
    m = n - k
    A = np.zeros((m, k), dtype=np.uint8)
    for j in range(m):
        for i in range(k):
            A[j, i] = gf256.gf_inv_np((k + j) ^ i)
    A.setflags(write=False)
    return A


@dataclasses.dataclass(frozen=True)
class RSCode(Code):
    """Systematic Reed-Solomon (Cauchy) code over GF(2^8)."""

    n: int
    k: int

    def __post_init__(self):
        if not (0 < self.k < self.n <= 256):
            raise ValueError(f"invalid RS parameters n={self.n} k={self.k}")

    @property
    def parity_matrix(self) -> np.ndarray:
        return _cauchy_parity(self.n, self.k)

    @property
    def generator(self) -> np.ndarray:
        """(n, k) systematic generator [I_k ; A]."""
        return np.concatenate([np.eye(self.k, dtype=np.uint8), self.parity_matrix])

    def encode(self, data):
        data = np.asarray(data, dtype=np.uint8)
        assert data.shape[0] == self.k, (data.shape, self.k)
        return gf256.gf_matmul_np(self.parity_matrix, data)

    def decode_matrix(self, available_idx) -> tuple[np.ndarray, list[int]]:
        """(k, k) inverse mapping k available chunks -> k data chunks."""
        avail = sorted(available_idx)
        if len(avail) < self.k:
            raise ValueError(
                f"need {self.k} chunks, got {len(avail)} — beyond erasure "
                f"tolerance of RS({self.n},{self.k})")
        idx = avail[: self.k]
        return gf256.gf_mat_inv(self.generator[idx]), idx

    def decode(self, available, wanted, chunk_size):
        inv, idx = self.decode_matrix(list(available.keys()))
        stacked = np.stack([np.asarray(available[i], dtype=np.uint8) for i in idx])
        data = gf256.gf_matmul_np(inv, stacked)  # (k, C)
        out = {}
        need_par = [w for w in wanted if w >= self.k]
        for w in wanted:
            if w < self.k:
                out[w] = data[w]
        if need_par:
            rows = self.generator[need_par]
            par = gf256.gf_matmul_np(rows, data)
            for r, w in enumerate(need_par):
                out[w] = par[r]
        return out

    def xor_delta(self, data_index, xor):
        xor = np.asarray(xor, dtype=np.uint8)
        gammas = self.parity_matrix[:, data_index]  # (m,)
        return gf256.MUL_TABLE[gammas[:, None], xor[None, :]]

    def parity_coeffs(self, data_index: int) -> np.ndarray:
        return self.parity_matrix[:, data_index]


# ---------------------------------------------------------------------------
# RDP — Row-Diagonal Parity (double-failure XOR code, paper Exp. 2)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _prime_at_least(x: int) -> int:
    def is_prime(v):
        if v < 2:
            return False
        f = 2
        while f * f <= v:
            if v % f == 0:
                return False
            f += 1
        return True

    p = x
    while not is_prime(p):
        p += 1
    return p


@dataclasses.dataclass(frozen=True)
class RDPCode(Code):
    """RDP(p): k data + 2 parity (row + diagonal), pure-XOR, tolerates any
    double erasure.  k real disks embed into the p-1 virtual disks of an RDP
    array with prime p >= k+1 (the rest are imaginary zero disks).  Chunks
    are viewed as (p-1, C/(p-1)) sub-block arrays; C=4096 uses p=17.

    Row parity  P[s]  = XOR_i D[i][s]
    Diag parity Q[d]  = XOR over {disk i at sub-row s : (i+s) mod p == d}
                        of D[i][s], including the row-parity disk at virtual
                        position k; diagonal p-1 is not stored.
    """

    n: int
    k: int
    p: int = 17

    def __post_init__(self):
        if self.n - self.k != 2:
            raise ValueError("RDP provides exactly 2 parity chunks")
        if self.k + 1 > self.p - 1:
            raise ValueError(f"RDP(p={self.p}) supports at most k={self.p-2}")

    @property
    def row_disk(self) -> int:
        """Virtual position of the row-parity disk in the diagonal layout."""
        return self.k

    def _blocks(self, chunk: np.ndarray) -> np.ndarray:
        C = chunk.shape[-1]
        r = self.p - 1
        if C % r:
            raise ValueError(f"chunk size {C} not divisible by p-1={r}")
        return chunk.reshape(chunk.shape[:-1] + (r, C // r))

    def encode(self, data):
        data = np.asarray(data, dtype=np.uint8)
        k, C = data.shape
        assert k == self.k
        r = self.p - 1
        blocks = self._blocks(data)  # (k, r, C/r)
        row_p = blocks[0].copy()
        for i in range(1, k):
            row_p ^= blocks[i]
        diag = np.zeros_like(row_p)
        cols = list(blocks) + [row_p]
        for i, col in enumerate(cols):  # virtual positions 0..k
            for s in range(r):
                d = (i + s) % self.p
                if d != self.p - 1:
                    diag[d] ^= col[s]
        return np.stack([row_p.reshape(C), diag.reshape(C)])

    def decode(self, available, wanted, chunk_size):
        missing = [i for i in range(self.n) if i not in available]
        if len(missing) > 2:
            raise ValueError("RDP tolerates at most 2 erasures")
        C = chunk_size
        r = self.p - 1
        kr = self.k * r

        def var(i, s):
            return i * r + s

        # Express every known disk as GF(2) equations over data sub-blocks.
        masks, rhss = [], []
        for i in range(self.k):
            if i in available:
                col = np.asarray(available[i], dtype=np.uint8).reshape(r, C // r)
                for s in range(r):
                    m = np.zeros(kr, dtype=np.uint8)
                    m[var(i, s)] = 1
                    masks.append(m)
                    rhss.append(col[s].copy())
        if self.k in available:  # row parity
            col = np.asarray(available[self.k], dtype=np.uint8).reshape(r, C // r)
            for s in range(r):
                m = np.zeros(kr, dtype=np.uint8)
                for i in range(self.k):
                    m[var(i, s)] = 1
                masks.append(m)
                rhss.append(col[s].copy())
        if self.k + 1 in available:  # diagonal parity
            col = np.asarray(available[self.k + 1], dtype=np.uint8).reshape(r, C // r)
            for d in range(r):
                m = np.zeros(kr, dtype=np.uint8)
                rhs = col[d].copy()
                for i in range(self.k):
                    s = (d - i) % self.p
                    if s < r:
                        m[var(i, s)] ^= 1
                # the row-parity disk's diagonal contribution
                s = (d - self.row_disk) % self.p
                if s < r:
                    if self.k in available:
                        rhs ^= np.asarray(available[self.k],
                                          dtype=np.uint8).reshape(r, C // r)[s]
                    else:
                        for i in range(self.k):  # expand rowP[s] = XOR_i D[i][s]
                            m[var(i, s)] ^= 1
                masks.append(m)
                rhss.append(rhs)
        # GF(2) Gaussian elimination with byte-vector right-hand sides.
        A = np.stack(masks)
        B = np.stack(rhss)
        piv_of = {}
        row = 0
        for col_i in range(kr):
            sel = next((rr for rr in range(row, A.shape[0]) if A[rr, col_i]), None)
            if sel is None:
                continue
            if sel != row:
                A[[row, sel]] = A[[sel, row]]
                B[[row, sel]] = B[[sel, row]]
            hit = (A[:, col_i] == 1)
            hit[row] = False
            A[hit] ^= A[row]
            B[hit] ^= B[row]
            piv_of[col_i] = row
            row += 1
        if len(piv_of) < kr:
            raise ValueError("RDP decode: system underdetermined")
        data = np.zeros((self.k, r, C // r), dtype=np.uint8)
        for i in range(self.k):
            for s in range(r):
                data[i, s] = B[piv_of[var(i, s)]]
        data = data.reshape(self.k, C)
        out = {}
        par = None
        for w in wanted:
            if w < self.k:
                out[w] = data[w]
            else:
                if par is None:
                    par = self.encode(data)
                out[w] = par[w - self.k]
        return out

    def xor_delta(self, data_index, xor):
        xor = np.asarray(xor, dtype=np.uint8)
        C = xor.shape[-1]
        r = self.p - 1
        xb = xor.reshape(r, C // r)
        diag_d = np.zeros((r, C // r), dtype=np.uint8)
        for src in (data_index, self.row_disk):  # direct + via row parity
            for s in range(r):
                d = (src + s) % self.p
                if d != self.p - 1:
                    diag_d[d] ^= xb[s]
        return np.stack([xor, diag_d.reshape(C)])

    def block_matrix(self) -> np.ndarray:
        """The code as one (2r, k*r) 0/1 matrix over sub-block rows.

        Chunk i reshapes to r = p-1 sub-block rows; column ``i*r + s``
        is disk i's sub-row s.  Output rows 0..r-1 are the row parity,
        rows r..2r-1 the diagonals (the row-parity disk's diagonal
        contribution expands to XOR over all data disks at its sub-row).
        This is the analytic form of what ``engine.block_rep`` used to
        probe out of ``encode`` with k*r basis vectors — pure-XOR, so
        every entry is 0/1 and the Pallas column-loop kernels apply.
        """
        r = self.p - 1
        E = np.zeros((2 * r, self.k * r), dtype=np.uint8)
        for i in range(self.k):
            for s in range(r):
                E[s, i * r + s] ^= 1                    # row parity
                d = (i + s) % self.p
                if d != self.p - 1:
                    E[r + d, i * r + s] ^= 1            # direct diagonal
        for s in range(r):  # row-parity disk's diagonal contribution
            d = (self.row_disk + s) % self.p
            if d != self.p - 1:
                for i in range(self.k):
                    E[r + d, i * r + s] ^= 1
        return E


# ---------------------------------------------------------------------------
# Single-parity XOR code (n = k + 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class XORCode(Code):
    n: int
    k: int

    def __post_init__(self):
        if self.n - self.k != 1:
            raise ValueError("XORCode has exactly 1 parity chunk")

    def encode(self, data):
        data = np.asarray(data, dtype=np.uint8)
        out = data[0].copy()
        for i in range(1, self.k):
            out ^= data[i]
        return out[None]

    def decode(self, available, wanted, chunk_size):
        missing = [i for i in range(self.n) if i not in available]
        if len(missing) > 1:
            raise ValueError("XOR code tolerates a single erasure")
        rec = None
        if missing:
            for c in available.values():
                c = np.asarray(c, dtype=np.uint8)
                rec = c.copy() if rec is None else rec ^ c
        out = {}
        for w in wanted:
            out[w] = (np.asarray(available[w], dtype=np.uint8)
                      if w in available else rec)
        return out

    def xor_delta(self, data_index, xor):
        return np.asarray(xor, dtype=np.uint8)[None]


# ---------------------------------------------------------------------------
# "No coding" — zero parity (paper Exp. 1 configuration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NoCode(Code):
    n: int

    @property
    def k(self) -> int:  # type: ignore[override]
        return self.n

    def encode(self, data):
        data = np.asarray(data, dtype=np.uint8)
        return np.zeros((0, data.shape[-1]), dtype=np.uint8)

    def decode(self, available, wanted, chunk_size):
        out = {}
        for w in wanted:
            if w not in available:
                raise ValueError("NoCode cannot reconstruct lost chunks")
            out[w] = np.asarray(available[w], dtype=np.uint8)
        return out

    def xor_delta(self, data_index, xor):
        return np.zeros((0, np.asarray(xor).shape[-1]), dtype=np.uint8)


def make_code(scheme: str, n: int, k: int) -> Code:
    scheme = scheme.lower()
    if scheme in ("rs", "reed-solomon", "reed_solomon"):
        return RSCode(n=n, k=k)
    if scheme == "rdp":
        return RDPCode(n=n, k=k, p=_prime_at_least(max(k + 2, 17)))
    if scheme == "xor":
        return XORCode(n=n, k=k)
    if scheme in ("none", "nocode", "no-coding"):
        return NoCode(n=n)
    raise ValueError(f"unknown coding scheme {scheme!r}")
