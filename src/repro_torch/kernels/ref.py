"""Pure-torch oracles for the coding kernels.

These mirror the numpy host data plane (``core.gf256``/``codes``) in
torch, so every kernel has an in-framework reference to sweep against.
They use the log/exp formulation, independent of the MUL-table gathers
of the kernels' plain versions.
"""
from __future__ import annotations

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
