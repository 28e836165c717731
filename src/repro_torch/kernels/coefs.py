"""Coefficients passed by value in the kernels' launch parameters.

The delta kernels (6, 7, 9) and the per-item kernels (4, 5) take their
coefficients, the shared-matrix kernels (1, 2, 8) their matrix's nibble
tables and the 0/1 kernel (3) its matrix's row masks, in a
``__grid_constant__`` parameter struct instead of a device buffer, so
their wrappers copy nothing to the card and never wait on the stream
(``csrc/gf256.cu``, "Coefficients by value", "Shared-matrix products by
value" and "The 0/1 product by value").  This module holds the host side
of that, in plain numpy, so it runs and is tested on any host:

* ``TIERS``: the byte sizes of the parameter struct the kernels are
  built in.  A launch picks the smallest that holds its coefficients;
  the largest stays under sm_90's 32,764 bytes of kernel parameters
  with room for the pointers and sizes.
* ``plan_launches``: a batch whose coefficients exceed the largest tier
  is split into launches of whole items, in order, on the same stream.
* ``row_masks``: a (B, O, J) 0/1 matrix (the reference's ``is01`` rule)
  as ceil(J / 8) little-endian bytes per output row, bit j set where the
  entry is 1; J <= ``MAX_MASK_COLS``.  RDP's (16, 16) seal systems take
  32 bytes per item this way, against 256 as bytes.
* ``per_item_coefs``: the form the per-item kernels get a batch of
  matrices in: row masks where they apply, else the bytes.
* ``gamma_bytes``: the delta kernels' gammas as bytes, ``g & 255``.
* ``matrix_tables``: a shared (m, k) matrix as its coefficients' nibble
  tables, six 32-bit words each (``struct Nib``: the products of the
  coefficient with the low and the high nibbles, ``NIB_WORDS``), 24 bytes
  a coefficient in row-major order; ``matrix_tier`` names the parameter
  tier they fit, or ``DEVICE`` above the largest (more than 1,360
  coefficients), where the wrapper keeps them in a device buffer instead.
* ``matrix_masks``: a shared 0/1 (M, K) matrix as the 0/1 kernel's row
  masks, ceil(K / 32) 32-bit words a row; ``matrix_tier`` names their
  tier too (``DEVICE`` above 8,160 words).
"""
from __future__ import annotations

import numpy as np

#: parameter-struct sizes in bytes, smallest first (``gf_coef_tier`` in
#: ``csrc/gf256.cu`` returns the same numbers)
TIERS = (512, 4096, 32640)
#: widest 0/1 row a mask holds (four bytes)
MAX_MASK_COLS = 32
#: the words of one coefficient's nibble tables, in the order of
#: ``struct Nib`` in ``csrc/gf256.cu``
NIB_WORDS = ("l0", "l1", "l8", "h0", "h1", "h8")
#: the tier index of tables that exceed every tier (``kDeviceTier``)
DEVICE = -1


def plan_launches(B: int, per_item: int,
                  tiers: tuple = TIERS) -> list[tuple[int, int, int]]:
    """Split ``B`` items of ``per_item`` coefficient bytes each into
    launches: ``[(start, end, tier), ...]`` covering items 0..B-1 once,
    in order, each launch holding as many whole items as the largest
    tier takes and naming the smallest tier index its bytes fit."""
    if per_item > tiers[-1]:
        raise ValueError(f"{per_item} coefficient bytes per item exceed the "
                         f"{tiers[-1]}-byte launch parameters")
    need = B * per_item
    if 0 < B and need <= tiers[-1]:        # the main path: one launch
        return [(0, B, next(i for i, t in enumerate(tiers) if need <= t))]
    step = tiers[-1] // per_item if per_item > 0 else max(B, 1)
    plan = []
    for s in range(0, B, step):
        e = min(B, s + step)
        need = (e - s) * per_item
        plan.append((s, e, next(i for i, t in enumerate(tiers) if need <= t)))
    return plan


def is01(Ms: np.ndarray) -> bool:
    """The reference's rule: a matrix whose entries are all 0 or 1."""
    return int(np.asarray(Ms).max(initial=0)) <= 1


def mask_bytes(J: int) -> int:
    """Bytes of one row mask of ``J`` columns."""
    return -(-J // 8)


def _pack(Ms: np.ndarray) -> np.ndarray:
    # rows padded to whole bytes, then one flat packbits (a packbits along
    # the last axis walks the rows one by one, tens of µs at B = 64)
    *lead, J = Ms.shape
    nb = mask_bytes(J)
    if J != 8 * nb:
        padded = np.zeros((*lead, 8 * nb), dtype=np.uint8)
        padded[..., :J] = Ms
        Ms = padded
    return np.packbits(Ms.reshape(-1), bitorder="little").reshape(*lead, nb)


def row_masks(Ms: np.ndarray) -> np.ndarray:
    """(B, O, J) 0/1 matrices -> (B, O, ceil(J/8)) uint8 row masks, bit
    j % 8 of byte j // 8 set where Ms[b, o, j] == 1."""
    Ms = np.ascontiguousarray(Ms, dtype=np.uint8)
    if Ms.shape[-1] > MAX_MASK_COLS or not is01(Ms):
        raise ValueError(f"row masks take 0/1 matrices of at most "
                         f"{MAX_MASK_COLS} columns, got {Ms.shape}")
    return _pack(Ms)


def per_item_coefs(Ms: np.ndarray) -> tuple[int, np.ndarray]:
    """(mask bytes per row, host coefficients) for the per-item kernels:
    (ceil(J/8), ``row_masks(Ms)``) for 0/1 matrices of at most
    ``MAX_MASK_COLS`` columns, else (0, the (B, O, J) bytes)."""
    Ms = np.ascontiguousarray(Ms, dtype=np.uint8)
    J = Ms.shape[-1]
    if J <= MAX_MASK_COLS and is01(Ms):
        return mask_bytes(J), _pack(Ms)
    return 0, Ms


def gamma_bytes(gammas) -> np.ndarray:
    """Gammas (a host array, a list, or a tensor, read back to the host
    first, which waits on its stream) as the uint8 bytes the delta
    kernels take: ``g & 255``, as the reference masks them."""
    if hasattr(gammas, "cpu"):
        gammas = gammas.cpu().numpy()
    g = np.asarray(gammas)
    return g if g.dtype == np.uint8 else (g & 255).astype(np.uint8)


def _xtime(v: np.ndarray) -> np.ndarray:
    d = v << np.uint32(1)
    return d ^ ((d >> np.uint32(8)) * np.uint32(0x11D))


def nib_words(g) -> np.ndarray:
    """(..., 6) uint32: the nibble tables of each coefficient ``g`` in
    ``NIB_WORDS`` order, as the kernels' ``nib_tables`` builds them from
    g's doublings p_j = g * 2^j (POLY 0x11D): l0, l1 hold g*i for i < 8
    one byte each, l8 g*8 in every byte; h0, h1, h8 the same for g*16."""
    p = [np.asarray(g, dtype=np.uint32) & np.uint32(255)]
    for _ in range(7):
        p.append(_xtime(p[-1]))
    rep = np.uint32(0x01010101)

    def first(a, b):            # g*0, a, b, a ^ b in the four bytes
        return (a << np.uint32(8)) | (b << np.uint32(16)) \
            | ((a ^ b) << np.uint32(24))
    l0, h0 = first(p[0], p[1]), first(p[4], p[5])
    return np.stack([l0, l0 ^ (p[2] * rep), p[3] * rep,
                     h0, h0 ^ (p[6] * rep), p[7] * rep], axis=-1)


_NIB = nib_words(np.arange(256)).astype("<u4")


def matrix_tables(A: np.ndarray) -> np.ndarray:
    """(m, k) matrix -> (m * k * 6,) little-endian uint32: the nibble
    tables of A[r, i] at words 6 * (r * k + i) onward."""
    return _NIB[np.asarray(A, dtype=np.uint8).reshape(-1)].reshape(-1)


def matrix_tier(nbytes: int, tiers: tuple = TIERS) -> int:
    """The smallest tier index whose struct holds ``nbytes`` of tables
    or masks, or ``DEVICE`` when none does."""
    return next((i for i, t in enumerate(tiers) if nbytes <= t), DEVICE)


def matrix_masks(A: np.ndarray) -> np.ndarray:
    """0/1 (M, K) matrix -> (M * ceil(K/32),) little-endian uint32 row
    masks, row-major: bit j % 32 of word j // 32 of row o is set where
    A[o, j] = 1."""
    A = np.asarray(A, dtype=np.uint8)
    M, K = A.shape
    words = -(-K // 32)
    packed = np.zeros((M, words * 4), dtype=np.uint8)
    packed[:, :mask_bytes(K)] = _pack(A)
    return packed.view("<u4").reshape(-1)
