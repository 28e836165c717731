"""Plain reference of the erasure-coded copy: GF(2^8), the page layout of
a (data A, model 1) mesh, and the parity of the rotated stripe lists.

A frozen statement of the format, written from its description and not
from the program's code:

* the field is GF(2^8) over x^8 + x^4 + x^3 + x^2 + 1 (0x11D); RS(n, k)
  is systematic Cauchy, parity row j, column i = 1 / ((k + j) XOR i);
* a mesh position d holds, of every parameter leaf in the tree's order
  (``refmodel.leaves``: dict keys sorted, a stacked leaf repeat by
  repeat), its block: the leaf cut into A equal slices along the one
  dimension the sharding rules place on "data" (whole where the rules
  name none or A does not divide that dimension), its bytes in row-major
  order, little-endian; the bytes of all leaves follow one another and
  are padded with zeros to whole stripes of k pages;
* page p of a position belongs to class j = p mod k and stripe s = p div
  k; list l holds class j of position (l + j) mod A, and its parity row
  r lives on position (l + k + r) mod A, so that position d's parity row
  r, stripe s is sum_j gamma[r, j] * page (s k + j) of position
  (d - k - r + j) mod A.

All products are on uint8 tensors on the device, with no tables:
multiplying by a constant is a shift-and-XOR over its bits.
"""
from __future__ import annotations

import re

import torch

POLY = 0x11D

#: the sharding rules' "data" placement, as the dimension counted from
#: the end of the leaf (a stacked leaf's repeats axis is never split)
DATA_DIM = [
    (r"embeddings\.embed$", -1),
    (r"embeddings\.unembed$", -2),
    (r"attn\.(wq|wk|wv)$", -2),
    (r"attn\.wo$", -1),
    (r"mla\.(w_dq|w_dkv)$", -2),
    (r"mla\.(w_uq|w_uk|w_uv)$", None),
    (r"mla\.wo$", -1),
    (r"mlp\.(w_gate|w_up)$", -2),
    (r"mlp\.w_down$", -1),
]


def gf_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= POLY
        b >>= 1
    return out


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return next(b for b in range(1, 256) if gf_mul(a, b) == 1)


def cauchy_parity(n: int, k: int) -> list:
    return [[gf_inv((k + j) ^ i) for i in range(k)] for j in range(n - k)]


def mul_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """c · x for every byte of the uint8 tensor ``x``."""
    out = torch.zeros_like(x)
    a = x.clone()
    while c:
        if c & 1:
            out ^= a
        c >>= 1
        if c:
            hi = (a >> 7) * 0x1D
            a = (a << 1) ^ hi
    return out


def data_dim(name: str, ndim: int) -> int | None:
    """The dimension of leaf ``name`` (of ``ndim`` dimensions) split over
    the data axis, or None (replicated)."""
    for pat, dim in DATA_DIM:
        if re.search(pat, name):
            if dim is None or ndim < -dim:
                return None
            return ndim + dim
    return None


def block(t: torch.Tensor, name: str, d: int, A: int) -> torch.Tensor:
    """Position d's block of leaf tensor ``t`` (a view)."""
    dim = data_dim(name, t.dim())
    if dim is None or t.shape[dim] % A:
        return t
    n = t.shape[dim] // A
    return t.narrow(dim, d * n, n)


def is_split(t: torch.Tensor, name: str, A: int) -> bool:
    dim = data_dim(name, t.dim())
    return dim is not None and t.shape[dim] % A == 0


def position_pages(tensors: list, d: int, A: int, k: int,
                   page: int) -> torch.Tensor:
    """Position d's pages (P, page) uint8 of the leaves ``tensors``, a list
    of (name, tensor) in the tree's order."""
    blocks = [block(t, name, d, A) for name, t in tensors]
    n = sum(b.numel() * b.element_size() for b in blocks)
    unit = k * page
    total = -(-n // unit) * unit
    out = torch.zeros(total, dtype=torch.uint8, device=blocks[0].device)
    off = 0
    for b in blocks:
        nb = b.numel() * b.element_size()
        out[off:off + nb] = b.contiguous().view(torch.uint8).reshape(-1)
        off += nb
    return out.view(-1, page)


def parity_row(pages: list, d: int, r: int, k: int, gamma: list,
               chunk: int = 1 << 18) -> torch.Tensor:
    """Position d's parity row r, (P/k, page), from every position's pages
    ``pages`` (a list of (P, page) tensors), in chunks of stripes."""
    A = len(pages)
    l = (d - k - r) % A
    S = pages[0].shape[0] // k
    out = torch.empty((S, pages[0].shape[1]), dtype=torch.uint8,
                      device=pages[0].device)
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        acc = None
        for j in range(k):
            src = pages[(l + j) % A].view(S, k, -1)[s0:s1, j]
            term = mul_const(src, gamma[r][j])
            acc = term if acc is None else acc ^ term
        out[s0:s1] = acc
    return out


def position_bytes(leaves, A: int) -> int:
    """Bytes of one position's blocks of ``leaves`` (``refmodel.Leaf``),
    before the padding to whole stripes."""
    total = 0
    for leaf in leaves:
        n = 1
        for x in leaf.shape:
            n *= x
        dim = data_dim(leaf.name, len(leaf.shape))
        if dim is not None and leaf.shape[dim] % A == 0:
            n //= A
        total += n * leaf.dtype.itemsize
    return total


def pages_per_position(leaves, A: int, k: int, page: int) -> int:
    unit = k * page
    return -(-position_bytes(leaves, A) // unit) * unit // page
