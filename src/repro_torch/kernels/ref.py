"""Pure-torch oracles for the coding kernels and the index probe.

These mirror the numpy host data plane (``core.gf256``/``codes``) in
torch, so every kernel has an in-framework reference to sweep against.
They use the log/exp formulation, independent of the MUL-table gathers
of the kernels' plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import gf256


def gf256_mul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(2^8) product via log/exp tables."""
    exp, log, _ = gf256.device_tables(b.device)
    a = a.to(torch.uint8)
    b = b.to(torch.uint8)
    prod = exp[(log[a.long()] + log[b.long()]) % 255]
    return torch.where((a == 0) | (b == 0), torch.zeros_like(prod), prod)


def gf256_matmul_ref(A: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul (m,k) x (k,C) -> (m,C) with XOR accumulation."""
    D = D.to(torch.uint8)
    A = torch.as_tensor(A, device=D.device).to(torch.uint8)
    m, k = A.shape
    out = torch.zeros((m,) + tuple(D.shape[1:]), dtype=torch.uint8,
                      device=D.device)
    for i in range(k):
        out ^= gf256_mul_ref(A[:, i][:, None].expand((m,) + tuple(D.shape[1:])),
                             D[i][None].expand((m,) + tuple(D.shape[1:])))
    return out


def delta_update_ref(parity: torch.Tensor, gammas: torch.Tensor,
                     old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """P_j' = P_j ⊕ gamma_j * (old ⊕ new)   (paper §2 linearity).

    parity: (m, C); gammas: (m,); old/new: (C,).
    """
    xor = old.to(torch.uint8) ^ new.to(torch.uint8)
    m, C = parity.shape
    scaled = gf256_mul_ref(
        gammas.to(device=xor.device, dtype=torch.uint8)[:, None].expand(m, C),
        xor[None].expand(m, C))
    return parity ^ scaled


def cuckoo_lookup_ref(flo: torch.Tensor, fhi: torch.Tensor,
                      occupied: torch.Tensor, b1: torch.Tensor,
                      b2: torch.Tensor, qlo: torch.Tensor, qhi: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched 2-bucket x 4-slot probe.

    Fingerprints are carried as (lo, hi) 32-bit halves, as the JAX
    package's oracle does (held in int64 tensors: torch's uint32 has few
    ops), independent of the kernel's 64-bit compare.  flo/fhi: (B,4)
    tables; occupied: (B,4); b1/b2: (Q,) bucket indices; qlo/qhi: (Q,).
    Returns (found: (Q,) bool, slot: (Q,) int32 = bucket*4+slot or -1).
    """
    b1, b2 = b1.long(), b2.long()
    hit1 = (occupied[b1] != 0) & (flo[b1] == qlo[:, None]) \
        & (fhi[b1] == qhi[:, None])
    hit2 = (occupied[b2] != 0) & (flo[b2] == qlo[:, None]) \
        & (fhi[b2] == qhi[:, None])
    slot_ids = torch.arange(4, device=flo.device)[None, :]
    big = 2 ** 30
    s1 = torch.where(hit1, b1[:, None] * 4 + slot_ids, big).min(dim=1).values
    s2 = torch.where(hit2, b2[:, None] * 4 + slot_ids, big).min(dim=1).values
    slot = torch.minimum(s1, s2)
    found = slot < big
    return found, torch.where(found, slot, -1).to(torch.int32)


def rs_encode_ref(parity_matrix: np.ndarray, data: torch.Tensor
                  ) -> torch.Tensor:
    """Stripe encode: (k, C) data -> (m, C) parity."""
    return gf256_matmul_ref(torch.from_numpy(
        np.array(parity_matrix, dtype=np.uint8)), data)


def rs_decode_ref(inv_matrix: np.ndarray, available: torch.Tensor
                  ) -> torch.Tensor:
    """Data reconstruction given host-inverted decode matrix (k,k)x(k,C)."""
    return gf256_matmul_ref(torch.from_numpy(
        np.array(inv_matrix, dtype=np.uint8)), available)
