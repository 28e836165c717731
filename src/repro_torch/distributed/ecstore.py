"""EC in-memory state store: the paper's architecture over a mesh.

MemEC's roles map onto the mesh's **data axis** (A positions per model
column).  Stripe lists (paper §4.3) are *rotationally symmetric*, as in
the reference (``src/repro/distributed/ecstore.py``):

    list l (l = 0..A-1):  data members  (l, l+1, ..., l+k-1) mod A
                          parity row r on position (l+k+r) mod A

Layout per position: its state bytes -> pages (P, page) uint8, page p of
class j = p mod k and stripe s = p div k belongs to list (d - j) mod A;
its parity (m, P//k, page): row r protects list (d - k - r) mod A.

The reference runs one device per position inside ``shard_map``.  The
port holds the positions in one of two ways, with the same bytes; they
move different blocks between positions.

**Stacked on one card** (``launch.train``, ``serve --protect``, the
train phases of ``chip_smoke.py``): every function takes and returns the
global arrays the reference's ``out_specs`` produce - pages ``(A_data,
A_model..., P, page)``, parity ``(A_data, A_model..., m, P/k, page)``,
the mesh axes in the mesh's order and ``data_dim`` naming the data axis
among them.  The products run on the shared-matrix kernel (kernel 1,
``kernels.gf256_matmul.gf256_matmul_batched``, on a CUDA tensor; its
plain version on a CPU tensor), with no loop over pages or stripes, and
the moves are in-card copies chosen for that:

* encode and the delta update (``_fold_parity``): each class j of the
  page buffer is rotated in place along the data axis by j positions
  (k - 1 moves of a class), so that item (l, s) holds stripe s of list
  l with its k members in order; one kernel-1 call with the (m, k) parity
  matrix computes every list's m parity pages, and row r is XORed into
  the parity buffer rolled by k + r positions (m moves): one launch per
  update, whatever the state's size;
* reconstruction (``reconstruct_failed``, ``reconstruct_failed_pair``):
  for each class j the survivors' pages are gathered at the failed
  position into a (items, survivors, page) batch and one kernel-1 call
  with the (1, survivors) decode row rebuilds that class: k launches;
* ``parity_delta_update_chain`` keeps the reference's m*k
  scale-and-shift steps (``collectives.gf_scale_static``).

**One position per rank** (``rank_*``, and ``ECStateStore`` with a
``comm`` from ``distributed/ranks.py``): the reference's per-device
bodies, line for line, on the rank's own ``(P, page)`` pages and ``(m,
P/k, page)`` parity, moving the reference's blocks:

* ``rank_parity_delta_update`` (and ``rank_encode_parity``): m*k sends
  of a class's gamma-scaled pages, (S, page) each, with shift
  (k + r - j) mod A;
* ``rank_parity_delta_update_chain``: the systolic ring, k*m + m(m-1)/2
  shifts by one;
* ``rank_reconstruct_failed`` and ``rank_reconstruct_failed_pair``: each
  rank's masked, coefficient-scaled contribution to each class, XOR-
  reduced over the ring: (A - 1)*k shifts.

A rank's products are one kernel-1 call per update (the (m*k, k) matrix
whose row r*k + j holds gamma[r, j] in column j gives every scaled class
at once) and at most 1 + m per class of a rebuild, on the card as on
the stacked store; the sends stay the reference's.

One difference from the reference: its single-failure reconstruction
picks parity row 0 at list position k, not k mod A, and a data member at
list position pos, not pos mod A, so on a mesh of A <= k positions it
drops those terms (on the 1 x 1 host mesh with k = m = 1 it rebuilds
zeros).  The port wraps both mod A in both forms, as the reference's own
encode and pair reconstruction do, so a rank equals the stacked store on
every mesh; where k + m <= A (every mesh the reference's tests use) both
agree with the reference byte for byte.

Storage overhead: m/k (25 % for RS(10,8)) vs 100 %+ for replication.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..core.codes import RSCode
from ..kernels import dispatch
from ..kernels.gf256_matmul import gf256_matmul_batched
from ..tree import Stacked, leaves, leaves_with_path, path_str
from .collectives import (gf_scale_static, note_permute, note_send,
                          rank_ring_xor_reduce_, ring_shift)
from .sharding import local_leaf_view


@dataclasses.dataclass(frozen=True)
class ECConfig:
    k: int = 8
    m: int = 2
    page_size: int = 4096
    axis: str = "data"

    @property
    def n(self) -> int:
        return self.k + self.m

    @property
    def code(self) -> RSCode:
        return RSCode(n=self.n, k=self.k)

    @property
    def gamma(self) -> np.ndarray:
        return self.code.parity_matrix  # (m, k)


# ---------------------------------------------------------------------------
# page packing
# ---------------------------------------------------------------------------

def _blocks(tree, specs, mesh) -> list:
    """The byte views of every leaf's local blocks, in the order a
    position's stream holds them: each ``(*mesh sizes, *block shape)``
    uint8, its last dimension times the element size (little-endian, as
    the reference's ``bitcast_convert_type``); without a mesh, the
    leaves' own bytes."""
    spec_leaves = leaves(specs) if specs is not None else None
    nd = 0 if mesh is None else len(mesh.axis_names)
    out = []
    for i, (path, leaf) in enumerate(leaves_with_path(tree)):
        if mesh is None:
            view = leaf
        elif spec_leaves is None or i >= len(spec_leaves):
            raise ValueError(f"{path_str(path)}: no spec")
        else:
            view = local_leaf_view(leaf, spec_leaves[i], mesh)
        for v in (view.parts if isinstance(view, Stacked) else [view]):
            if v.dim() == nd:                      # a 0-d leaf
                v = v.unsqueeze(-1)
            out.append(v if v.dtype == torch.uint8 else v.view(torch.uint8))
    return out


def pack_bytes(tree, specs=None, mesh=None, *, out=None, xor=False,
               pad_to: int = 1) -> torch.Tensor:
    """Every position's share of ``tree`` as bytes in ``jax.tree.leaves``
    order: ``(*mesh sizes, n)`` uint8 (``(n,)`` without a mesh), n padded
    with zeros to a multiple of ``pad_to``.  With ``out`` the bytes are
    written into it (``xor``: XORed into it) instead of a new tensor."""
    if specs is not None and len(leaves(specs)) != len(leaves(tree)):
        raise ValueError(f"{len(leaves(specs))} specs for "
                         f"{len(leaves(tree))} leaves")
    lead = () if mesh is None else tuple(mesh.axis_sizes)
    blocks = _blocks(tree, specs, mesh)
    sizes = [math.prod(b.shape[len(lead):]) for b in blocks]
    n = sum(sizes)
    total = -(-n // pad_to) * pad_to
    if out is None:
        dev = blocks[0].device if blocks else torch.device("cpu")
        out = torch.zeros(lead + (total,), dtype=torch.uint8, device=dev)
        xor = False
    elif tuple(out.shape) != lead + (total,) or out.dtype != torch.uint8:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype}, expected "
                         f"{lead + (total,)} uint8")
    elif not xor:
        out[..., n:].zero_()
    off = 0
    for block, size in zip(blocks, sizes):
        dst = out[..., off:off + size].view(block.shape)
        if xor:
            dst ^= block
        else:
            dst.copy_(block)
        off += size
    return out


def bytes_of_tree(tree, specs=None, mesh=None) -> torch.Tensor:
    """Flatten a tree's local shards into bytes: ``(n,)`` for a tree with
    no mesh, ``(*mesh sizes, n)`` - every position's ``bytes_of_tree`` of
    the reference - with ``specs`` and ``mesh``."""
    return pack_bytes(tree, specs, mesh)


def to_pages(flat: torch.Tensor, cfg: ECConfig) -> torch.Tensor:
    """``(..., n)`` bytes -> ``(..., P, page)``, zero-padded to whole
    stripes."""
    unit = cfg.k * cfg.page_size
    pad = (-flat.shape[-1]) % unit
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(flat.shape[:-1] + (-1, cfg.page_size))


def tree_xor_pages(old_tree, new_tree, cfg: ECConfig, specs=None,
                   mesh=None) -> torch.Tensor:
    """(old ⊕ new) as pages - the data delta of the paper's UPDATE."""
    buf = pack_bytes(old_tree, specs, mesh)
    return to_pages(pack_bytes(new_tree, specs, mesh, out=buf, xor=True),
                    cfg)


# ---------------------------------------------------------------------------
# core EC ops on stacked pages
# ---------------------------------------------------------------------------

def _check(pages: torch.Tensor, cfg: ECConfig, data_dim: int) -> tuple:
    if pages.dtype != torch.uint8 or pages.dim() < 3:
        raise ValueError(f"pages {tuple(pages.shape)} {pages.dtype}: "
                         f"expected (A..., P, page) uint8")
    Pn, page = pages.shape[-2:]
    if page != cfg.page_size or Pn % cfg.k:
        raise ValueError(f"pages (P {Pn}, page {page}) for k {cfg.k}, "
                         f"page {cfg.page_size}")
    if not 0 <= data_dim < pages.dim() - 2:
        raise ValueError(f"data_dim {data_dim} for pages "
                         f"{tuple(pages.shape)}")
    return pages.shape[data_dim], Pn // cfg.k, page


def _rotate_lists_(pages: torch.Tensor, cfg: ECConfig, data_dim: int):
    """In place: class j's pages move from position (l + j) mod A to
    position l, so that (l, stripe s) holds stripe s of list l, member j
    at class slot j.  One temporary of one position's class j."""
    A, S, page = _check(pages, cfg, data_dim)
    cls = pages.unflatten(-2, (S, cfg.k))
    for j in range(1, cfg.k):
        shift = j % A
        if not shift:
            continue
        plane = cls.select(-2, j)
        note_permute(plane, data_dim, shift)
        for c in range(math.gcd(A, shift)):
            tmp = plane.select(data_dim, c).clone()
            i = c
            while (nxt := (i + shift) % A) != c:
                plane.select(data_dim, i).copy_(plane.select(data_dim, nxt))
                i = nxt
            plane.select(data_dim, i).copy_(tmp)


def _xor_rolled_(dst: torch.Tensor, src: torch.Tensor, shift: int,
                 dim: int) -> None:
    """dst ^= roll(src, shift) along ``dim``, without the roll's copy."""
    A = src.shape[dim]
    t = shift % A
    note_permute(src, dim, t)
    if t == 0:
        dst ^= src
        return
    dst.narrow(dim, t, A - t).bitwise_xor_(src.narrow(dim, 0, A - t))
    dst.narrow(dim, 0, t).bitwise_xor_(src.narrow(dim, A - t, t))


def _fold_parity(pages: torch.Tensor, parity: torch.Tensor, cfg: ECConfig,
                 data_dim: int) -> torch.Tensor:
    """parity ^= the parity of ``pages``, in place; ``pages`` (contiguous)
    is left rotated into list order (scratch)."""
    A, S, page = _check(pages, cfg, data_dim)
    want = pages.shape[:-2] + (cfg.m, S, page)
    if tuple(parity.shape) != want or parity.dtype != torch.uint8:
        raise ValueError(f"parity {tuple(parity.shape)} {parity.dtype}, "
                         f"expected {want} uint8")
    _rotate_lists_(pages, cfg, data_dim)
    out = gf256_matmul_batched(cfg.gamma, pages.view(-1, cfg.k, page))
    out = out.view(pages.shape[:-2] + (S, cfg.m, page))
    for r in range(cfg.m):
        _xor_rolled_(parity.select(-3, r), out.select(-2, r),
                     cfg.k + r, data_dim)
    return parity


def parity_delta_update(xor_pages: torch.Tensor, parity: torch.Tensor,
                        cfg: ECConfig, data_dim: int = 0) -> torch.Tensor:
    """P' = P ⊕ gamma·(D ⊕ D') routed to the rotated parity owners.

    xor_pages: (A..., P, page) delta of every position; parity: (A...,
    m, P//k, page).  Returns the new parity; the inputs are kept."""
    return _fold_parity(xor_pages.contiguous().clone(), parity.clone(), cfg,
                        data_dim)


def parity_delta_update_chain(xor_pages: torch.Tensor, parity: torch.Tensor,
                              cfg: ECConfig, data_dim: int = 0
                              ) -> torch.Tensor:
    """The reference's systolic variant of ``parity_delta_update``:
    partial parities accumulate along a shift-1 ring - at step t every
    position XORs gamma[r,t] * (its class-t delta) into the m bundles
    passing through it, then forwards them one hop; row r then travels r
    more hops to its owner.  Same bytes as the direct update; m*k
    ``gf_scale_static`` calls."""
    A, S, page = _check(xor_pages, cfg, data_dim)
    cls = xor_pages.unflatten(-2, (S, cfg.k))
    gamma = cfg.gamma
    shape = xor_pages.shape[:-2] + (S, page)
    bundles = [torch.zeros(shape, dtype=torch.uint8, device=xor_pages.device)
               for _ in range(cfg.m)]
    for t in range(cfg.k):
        for r in range(cfg.m):
            bundles[r] = bundles[r] ^ gf_scale_static(int(gamma[r, t]),
                                                      cls.select(-2, t))
        bundles = [ring_shift(b, 1, data_dim) for b in bundles]
    rows = []
    for r in range(cfg.m):
        b = bundles[r]
        for _ in range(r):
            b = ring_shift(b, 1, data_dim)
        rows.append(parity.select(-3, r) ^ b)
    return torch.stack(rows, dim=-3)


def encode_parity(pages: torch.Tensor, cfg: ECConfig,
                  data_dim: int = 0) -> torch.Tensor:
    """Full encode = delta update from an all-zero parity."""
    A, S, page = _check(pages, cfg, data_dim)
    parity = torch.zeros(pages.shape[:-2] + (cfg.m, S, page),
                         dtype=torch.uint8, device=pages.device)
    return _fold_parity(pages.contiguous().clone(), parity, cfg, data_dim)


@functools.lru_cache(maxsize=None)
def _decode_coeffs(k: int, m: int, failed_class: int) -> tuple:
    """Coefficients reconstructing data chunk `failed_class` from the
    surviving k-1 data chunks + parity row 0 (single-device loss)."""
    code = RSCode(n=k + m, k=k)
    avail = [i for i in range(k) if i != failed_class] + [k]
    inv, idx = code.decode_matrix(avail)
    coeffs = {pos: int(inv[failed_class, i]) for i, pos in enumerate(idx)}
    return tuple(sorted(coeffs.items()))


@functools.lru_cache(maxsize=None)
def _decode_coeffs_pair(k: int, m: int, want: int, other: int,
                        rows: tuple) -> tuple:
    """Coefficients for data position `want` when data positions
    {want, other} are erased (other = -1 if the second failure holds no
    data chunk in this stripe) using parity rows `rows`."""
    code = RSCode(n=k + m, k=k)
    missing = {want} | ({other} if other >= 0 else set())
    avail = [i for i in range(k) if i not in missing] + \
        [k + r for r in rows]
    inv, idx = code.decode_matrix(avail)
    coeffs = {pos: int(inv[want, i]) for i, pos in enumerate(idx)}
    return tuple(sorted((p, c) for p, c in coeffs.items() if c != 0))


def _rebuild(pages, parity, cfg: ECConfig, data_dim: int, f: int,
             terms_of) -> torch.Tensor:
    """Pages of position ``f``.  ``terms_of(j)`` lists class j's
    survivors as (coefficient, position in list f - j, parity row or None
    for a data member); one kernel-1 call a class sums them.  The result
    is replicated along the data axis, as the reference's XOR-reduce
    leaves it."""
    A, S, page = _check(pages, cfg, data_dim)
    cls = pages.unflatten(-2, (S, cfg.k))
    rest = pages.shape[:data_dim] + pages.shape[data_dim + 1:-2]
    rec = torch.empty(rest + (S, cfg.k, page), dtype=torch.uint8,
                      device=pages.device)
    for j in range(cfg.k):
        terms = terms_of(j)
        srcs = []
        for _, pos, row in terms:
            at = (f - j + pos) % A
            srcs.append(cls.select(data_dim, at).select(-2, pos)
                        if row is None else
                        parity.select(data_dim, at).select(-3, row))
            if at != f:
                note_send(srcs[-1])
        items = torch.stack(srcs, dim=-2).reshape(-1, len(srcs), page)
        row_coefs = np.array([[c for c, _, _ in terms]], dtype=np.uint8)
        rec.select(-2, j).copy_(gf256_matmul_batched(row_coefs, items)
                                .view(rest + (S, page)))
    rec = rec.reshape(rest + (S * cfg.k, page))
    return rec.unsqueeze(data_dim).expand(pages.shape)


def reconstruct_failed(pages: torch.Tensor, parity: torch.Tensor,
                       failed: int, cfg: ECConfig,
                       data_dim: int = 0) -> torch.Tensor:
    """Rebuild the pages of data position ``failed`` from the survivors of
    each of its lists (decode-from-k with parity row 0; the paper's
    degraded GET at page granularity, §5.4).  Returns (A..., P, page),
    the rebuilt pages at every data position, as the reference's ring
    XOR-reduce leaves them."""
    A = pages.shape[data_dim]
    failed = int(failed) % A

    def terms(j):
        return [(c, pos, None if pos < cfg.k else 0)
                for pos, c in _decode_coeffs(cfg.k, cfg.m, j)]

    return _rebuild(pages, parity, cfg, data_dim, failed, terms)


def _pair_terms(cfg: ECConfig, f1: int, f2: int, A: int):
    """``terms_of`` for rebuilding f1 when f1 and f2 are lost: list l =
    f1 - j holds f1 at data position j, f2 at pos2 = (f2 - f1 + j) mod A
    (a data member iff pos2 < k), parity row r's owner at (k + r) mod
    A."""
    def terms(j):
        pos2 = (f2 - f1 + j) % A
        data_missing = [j] + ([pos2] if pos2 < cfg.k else [])
        failed_pos = {j, pos2}
        rows_avail = [r for r in range(cfg.m)
                      if (cfg.k + r) % A not in failed_pos]
        if len(rows_avail) < len(data_missing):
            raise ValueError(
                f"class {j}: not enough surviving parity rows "
                f"(RS({cfg.n},{cfg.k}) over axis {A}) — stripe "
                "undecodable for this failure pair")
        rows = tuple(rows_avail[: len(data_missing)])
        other = pos2 if pos2 < cfg.k else -1
        return [(c, pos, None if pos < cfg.k else pos - cfg.k)
                for pos, c in _decode_coeffs_pair(cfg.k, cfg.m, j, other,
                                                  rows)]
    return terms


def reconstruct_failed_pair(pages: torch.Tensor, parity: torch.Tensor,
                            f1: int, f2: int, axis_size: int,
                            cfg: ECConfig, data_dim: int = 0
                            ) -> torch.Tensor:
    """Rebuild position f1's pages when positions {f1, f2} are both lost
    (m >= 2 tolerance).  Call twice (swapping f1/f2) to rebuild both.

    Positions are relative to list l = f1 - j: f1 sits at data position
    j, f2 at pos2 = (f2 - f1 + j) mod A (a data member iff pos2 < k),
    parity row r's owner at (k + r) mod A."""
    A = axis_size
    if pages.shape[data_dim] != A:
        raise ValueError(f"axis_size {A}, pages {tuple(pages.shape)}")
    return _rebuild(pages, parity, cfg, data_dim, int(f1) % A,
                    _pair_terms(cfg, f1, f2, A))


# ---------------------------------------------------------------------------
# core EC ops on one rank (the reference's per-device bodies)
# ---------------------------------------------------------------------------

def _rank_check(pages: torch.Tensor, cfg: ECConfig) -> tuple:
    if pages.dtype != torch.uint8 or pages.dim() != 2:
        raise ValueError(f"pages {tuple(pages.shape)} {pages.dtype}: "
                         f"expected (P, page) uint8")
    Pn, page = pages.shape
    if page != cfg.page_size or Pn % cfg.k:
        raise ValueError(f"pages (P {Pn}, page {page}) for k {cfg.k}, "
                         f"page {cfg.page_size}")
    return Pn // cfg.k, page


@functools.lru_cache(maxsize=None)
def _scaling_matrix(k: int, m: int) -> np.ndarray:
    """(m*k, k): row r*k + j holds gamma[r, j] in column j."""
    gamma = ECConfig(k=k, m=m).gamma
    out = np.zeros((m * k, k), dtype=np.uint8)
    for r in range(m):
        for j in range(k):
            out[r * k + j, j] = gamma[r, j]
    out.setflags(write=False)
    return out


def _scaled_classes(pages: torch.Tensor, cfg: ECConfig, comm,
                    op: str) -> torch.Tensor:
    """gamma[r, j] * (class j of ``pages``) for every (r, j), one
    kernel-1 call: ``(S, m*k, page)``, column r*k + j."""
    S, page = _rank_check(pages, cfg)
    comm.op_paths[op] = dispatch.decide(pages).path
    return gf256_matmul_batched(_scaling_matrix(cfg.k, cfg.m),
                                pages.contiguous().view(S, cfg.k, page))


def _rank_fold_(xor_pages: torch.Tensor, parity: torch.Tensor,
                cfg: ECConfig, comm, op: str = "update") -> torch.Tensor:
    """parity ^= the parity of ``xor_pages``, in place: the reference's
    ``parity_delta_update``, m*k gamma-scaled sends."""
    S, page = _rank_check(xor_pages, cfg)
    if tuple(parity.shape) != (cfg.m, S, page) or \
            parity.dtype != torch.uint8:
        raise ValueError(f"parity {tuple(parity.shape)} {parity.dtype}, "
                         f"expected {(cfg.m, S, page)} uint8")
    A = comm.axis_size
    scaled = _scaled_classes(xor_pages, cfg, comm, op)
    for r in range(cfg.m):
        for j in range(cfg.k):
            parity[r] ^= comm.shift(scaled[:, r * cfg.k + j],
                                    (cfg.k + r - j) % A)
    return parity


def rank_parity_delta_update(xor_pages: torch.Tensor, parity: torch.Tensor,
                             cfg: ECConfig, comm) -> torch.Tensor:
    """P' = P ⊕ gamma·(D ⊕ D') routed to the rotated parity owners, on one
    rank: xor_pages (P, page) this rank's delta, parity (m, P//k, page)
    its parity; m*k gamma-scaled sends, shift (k + r - j) mod A.  Returns
    the new parity; the inputs are kept."""
    return _rank_fold_(xor_pages, parity.clone(), cfg, comm)


def rank_parity_delta_update_chain(xor_pages: torch.Tensor,
                                   parity: torch.Tensor, cfg: ECConfig,
                                   comm) -> torch.Tensor:
    """The reference's systolic variant on one rank: at step t the rank
    XORs gamma[r, t] * (its class-t delta) into the m bundles passing
    through it, then forwards them one hop; row r then travels r more
    hops to its owner.  k*m + m(m-1)/2 shifts by one."""
    S, page = _rank_check(xor_pages, cfg)
    scaled = _scaled_classes(xor_pages, cfg, comm, "update_chain")
    bundles = [torch.zeros((S, page), dtype=torch.uint8,
                           device=xor_pages.device) for _ in range(cfg.m)]
    for t in range(cfg.k):
        for r in range(cfg.m):
            bundles[r] ^= scaled[:, r * cfg.k + t]
        bundles = [comm.shift(b, 1) for b in bundles]
    out = parity.clone()
    for r in range(cfg.m):
        b = bundles[r]
        for _ in range(r):
            b = comm.shift(b, 1)
        out[r] ^= b
    return out


def rank_encode_parity(pages: torch.Tensor, cfg: ECConfig,
                       comm) -> torch.Tensor:
    """Full encode on one rank = delta update from an all-zero parity."""
    S, page = _rank_check(pages, cfg)
    parity = torch.zeros((cfg.m, S, page), dtype=torch.uint8,
                         device=pages.device)
    return _rank_fold_(pages, parity, cfg, comm, "encode")


def _rank_rebuild(pages, parity, cfg: ECConfig, comm, f: int, terms_of,
                  op: str) -> torch.Tensor:
    """Position f's pages on every rank of its column.  ``terms_of(j)``
    lists class j's survivors as (coefficient, position in list f - j,
    parity row or None for a data member); the rank scales those it holds
    (list position pos lies on data index (f - j + pos) mod A) and the
    ring XOR-reduces each class's contributions."""
    S, page = _rank_check(pages, cfg)
    A, d = comm.axis_size, comm.index
    comm.op_paths[op] = dispatch.decide(pages).path
    cls = pages.contiguous().view(S, cfg.k, page)
    out = torch.empty((S, cfg.k, page), dtype=torch.uint8,
                      device=pages.device)
    for j in range(cfg.k):
        data_row = np.zeros((1, cfg.k), dtype=np.uint8)
        contrib = None
        for coeff, pos, row in terms_of(j):
            if (f - j + pos) % A != d:
                continue
            if row is None:
                data_row[0, pos] = coeff
                continue
            term = gf256_matmul_batched(
                np.array([[coeff]], np.uint8),
                parity[row].contiguous().view(S, 1, page)).view(S, page)
            contrib = term if contrib is None else contrib.bitwise_xor_(term)
        if data_row.any():
            term = gf256_matmul_batched(data_row, cls).view(S, page)
            contrib = term if contrib is None else contrib.bitwise_xor_(term)
        if contrib is None:
            contrib = torch.zeros((S, page), dtype=torch.uint8,
                                  device=pages.device)
        out[:, j] = rank_ring_xor_reduce_(contrib, comm)
    return out.view(S * cfg.k, page)


def rank_reconstruct_failed(pages: torch.Tensor, parity: torch.Tensor,
                            failed: int, cfg: ECConfig, comm
                            ) -> torch.Tensor:
    """Rebuild the pages of data index ``failed`` on one rank: every rank
    contributes its coefficient-scaled chunk of each class, masked to the
    survivors the decode uses (k - 1 data members and parity row 0), and
    a ring XOR-reduce lands the result on every rank of the column.
    Returns (P, page)."""
    failed = int(failed) % comm.axis_size

    def terms(j):
        return [(c, pos, None if pos < cfg.k else 0)
                for pos, c in _decode_coeffs(cfg.k, cfg.m, j)]

    return _rank_rebuild(pages, parity, cfg, comm, failed, terms,
                         "reconstruct")


def rank_reconstruct_failed_pair(pages: torch.Tensor, parity: torch.Tensor,
                                 f1: int, f2: int, cfg: ECConfig, comm
                                 ) -> torch.Tensor:
    """Rebuild data index f1's pages on one rank when f1 and f2 are both
    lost (``reconstruct_failed_pair``'s terms, each rank scaling those it
    holds, XOR-reduced over the ring).  Call twice (swapping f1/f2) to
    rebuild both."""
    A = comm.axis_size
    return _rank_rebuild(pages, parity, cfg, comm, int(f1) % A,
                         _pair_terms(cfg, f1, f2, A), "reconstruct_pair")


# ---------------------------------------------------------------------------
# tree-level store
# ---------------------------------------------------------------------------

class ECStateStore:
    """Erasure-coded in-memory protection of a state tree laid out over a
    mesh (``launch.mesh.Mesh``) by ``state_specs`` (``sharding.P`` per
    leaf).

    Without ``comm`` every position is stacked on one card: the methods
    take the whole tree and parity is an ``(A_data, A_other..., m, P/k,
    page)`` uint8 tensor on the state's device.  With ``comm``
    (``distributed.ranks.RankComm``, or ``CountingComm``) the store is one
    rank's: the methods take the rank's local tree (its blocks,
    ``sharding.local_block``) and return its ``(P, page)`` pages and
    ``(m, P/k, page)`` parity, moving the reference's blocks (module
    notes)."""

    def __init__(self, mesh, state_specs, cfg: ECConfig | None = None,
                 comm=None):
        self.mesh = mesh
        self.cfg = cfg or ECConfig()
        self.state_specs = state_specs
        if self.cfg.axis not in mesh.axis_names:
            raise ValueError(f"axis {self.cfg.axis!r} not in mesh "
                             f"{mesh.axis_names}")
        if comm is not None and (comm.mesh != mesh
                                 or comm.axis != self.cfg.axis):
            raise ValueError(f"comm on {comm.mesh} axis {comm.axis!r}, "
                             f"store on {mesh} axis {self.cfg.axis!r}")
        self.data_dim = tuple(mesh.axis_names).index(self.cfg.axis)
        self.comm = comm

    def pack(self, state, out: torch.Tensor | None = None,
             xor: bool = False) -> torch.Tensor:
        """The state's pages ``(A..., P, page)`` (a rank's ``(P, page)``):
        a new tensor, or written (``xor``: XORed) into ``out``, a page
        buffer of that shape."""
        cfg = self.cfg
        flat = None if out is None else out.view(out.shape[:-2] + (-1,))
        mesh = self.mesh if self.comm is None else None
        flat = pack_bytes(state, self.state_specs, mesh, out=flat,
                          xor=xor, pad_to=cfg.k * cfg.page_size)
        return flat.view(flat.shape[:-1] + (-1, cfg.page_size))

    def local_pages(self, state) -> torch.Tensor:
        """(A_data, A_other..., P, page) global view of state pages (a
        rank's (P, page))."""
        return self.pack(state)

    def fold(self, pages: torch.Tensor, parity: torch.Tensor) -> None:
        """parity ^= the parity of ``pages``, in place; the stacked store
        uses ``pages`` as scratch (rotated in place), a rank's keeps it."""
        if self.comm is None:
            _fold_parity(pages, parity, self.cfg, self.data_dim)
        else:
            _rank_fold_(pages, parity, self.cfg, self.comm)

    def zero_parity(self, pages: torch.Tensor) -> torch.Tensor:
        """An all-zero parity buffer for ``pages``."""
        cfg = self.cfg
        return torch.zeros(pages.shape[:-2] + (
            cfg.m, pages.shape[-2] // cfg.k, cfg.page_size),
            dtype=torch.uint8, device=pages.device)

    def encode(self, state) -> torch.Tensor:
        pages = self.pack(state)
        parity = self.zero_parity(pages)
        self.fold(pages, parity)
        return parity

    def delta_update(self, old_state, new_state, parity) -> torch.Tensor:
        pages = self.pack(old_state)
        self.pack(new_state, out=pages, xor=True)
        new = parity.clone()
        self.fold(pages, new)
        return new

    def reconstruct(self, state, parity, failed_index: int) -> torch.Tensor:
        """Pages of the failed data-axis position (at every position; on
        a rank, ``(P, page)``)."""
        if self.comm is not None:
            return rank_reconstruct_failed(self.pack(state), parity,
                                           failed_index, self.cfg, self.comm)
        return reconstruct_failed(self.pack(state), parity, failed_index,
                                  self.cfg, self.data_dim)
