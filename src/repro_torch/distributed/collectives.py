"""Collective building blocks: GF(2^8) scaling, XOR rings, compressed
psum, in two forms.

The reference runs these inside ``shard_map`` bodies, one device per
mesh position, with ``ppermute``/``all_gather`` between devices
(``src/repro/distributed/collectives.py``).  The port has them twice:

* stacked (``ring_shift``, ``ring_xor_reduce``, ``compressed_psum``):
  every position on one card, the mesh axis a tensor dimension ``dim``;
  a ring shift is a roll along it and a reduction a reduction over it,
  and the results keep that dimension, holding at each position what the
  reference's position holds;
* per rank (``rank_ring_shift``, ``rank_ring_xor_reduce``,
  ``rank_compressed_psum``): one position's block on one rank of a
  process group, moved by a communicator (``distributed/ranks.py``), step
  for step as the reference: a shift is one send and one receive, the
  XOR-reduce A - 1 shift-and-XOR steps, the psum an ``all_gather`` of
  int8 payloads and fp32 scales summed in data order.

``gf_scale_static`` multiplies by a static coefficient over GF(2^8).  On
a CUDA tensor it is one launch of the shared-matrix product kernel
(``kernels.gf256_matmul.gf256_matmul_batched`` with the (1, 1) matrix
[gamma], kernel 1); on a CPU tensor it is the reference's bit-plane
identity gamma*x = XOR_b bit_b(x) * (gamma*2^b) in torch.

Where a position's block moves to another position (``ring_shift``, the
stacked EC store's rotations, rolled XORs and rebuild gathers, and every
send of a rank's communicator), the mover calls ``note_permute`` or
``note_send``: inside ``recording`` (``launch/cost_analysis.py``) that
counts the bytes the positions send to other cards, by the kind of the
reference's collective (``collective-permute`` for a shift or a rotation;
``all-gather`` and ``all-reduce`` for a rank communicator's gathers and
sums); outside it costs one attribute read.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from ..core import gf256
from ..kernels import dispatch
from ..kernels.gf256_matmul import gf256_matmul_batched


@functools.lru_cache(maxsize=None)
def _gamma_pows(gamma: int) -> tuple:
    return tuple(int(gf256.MUL_TABLE[gamma, 1 << b]) for b in range(8))


def gf_scale_static_plain(gamma: int, x: torch.Tensor) -> torch.Tensor:
    """gamma * x by the bit-plane identity, in int32 as the reference."""
    xi = x.to(torch.int32)
    acc = torch.zeros_like(xi)
    for b, g in enumerate(_gamma_pows(gamma)):
        acc ^= ((xi >> b) & 1) * g
    return acc.to(torch.uint8)


def gf_scale_static(gamma: int, x: torch.Tensor) -> torch.Tensor:
    """gamma * x over GF(2^8) for a static gamma; x uint8 of any shape
    (its last dimension is the kernel's byte run)."""
    gamma = int(gamma)
    if gamma == 0:
        return torch.zeros_like(x)
    if gamma == 1:
        return x
    if dispatch.decide(x).path == dispatch.TORCH_CPU or x.numel() == 0:
        return gf_scale_static_plain(gamma, x)
    flat = x.contiguous().reshape(-1, 1, x.shape[-1] if x.dim() else 1)
    out = gf256_matmul_batched(np.array([[gamma]], np.uint8), flat)
    return out.reshape(x.shape)


#: the active ``recording`` callback of this thread (``.callback``), as
#: ``dispatch.dry_run`` is kept: a count in one thread sees no other
#: thread's moves (the sharded cluster's workers)
_recorder = threading.local()


PERMUTE = "collective-permute"


@contextlib.contextmanager
def recording(callback):
    """Call ``callback(nbytes, kind)`` with the bytes and the collective's
    kind of every move between positions that this thread makes while the
    context is active."""
    prev = getattr(_recorder, "callback", None)
    _recorder.callback = callback
    try:
        yield
    finally:
        _recorder.callback = prev


def note_bytes(nbytes: int, kind: str = PERMUTE) -> None:
    """``nbytes`` sent to other positions by a collective of ``kind``."""
    callback = getattr(_recorder, "callback", None)
    if callback is not None:
        callback(int(nbytes), kind)


def note_permute(x: torch.Tensor, dim: int, shift: int) -> None:
    """Every position along ``dim`` of ``x`` (every position's block)
    sends its block ``shift`` positions on; nothing moves when the shift
    is a multiple of the axis."""
    if int(shift) % x.shape[dim]:
        note_bytes(x.numel() * x.element_size())


def note_send(blocks: torch.Tensor, kind: str = PERMUTE) -> None:
    """The positions holding ``blocks`` send them to other positions."""
    note_bytes(blocks.numel() * blocks.element_size(), kind)


def ring_shift(x: torch.Tensor, shift: int, dim: int = 0) -> torch.Tensor:
    """Position i's block goes to (i + shift) mod A along ``dim``."""
    note_permute(x, dim, shift)
    return torch.roll(x, shifts=int(shift), dims=dim)


def ring_xor_reduce(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """XOR of the blocks along ``dim``, at every position (the reference's
    A - 1 shift-and-XOR steps)."""
    acc = x.select(dim, 0).clone()
    for i in range(1, x.shape[dim]):
        acc ^= x.select(dim, i)
    return acc.unsqueeze(dim).expand(x.shape)


def compressed_psum(x: torch.Tensor, dim: int = 0, *, block: int = 256
                    ) -> torch.Tensor:
    """int8-quantized sum along ``dim`` (cross-pod gradient compression):
    each position quantizes its block to int8 with per-block absmax
    scales; the sum of the dequantized blocks lands at every position."""
    xs = x.movedim(dim, 0)
    A = xs.shape[0]
    flat = xs.reshape(A, -1)
    n = flat.shape[1]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(A, -1, block)
    scale = torch.amax(torch.abs(blocks), dim=2, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    out = torch.sum(q.to(torch.float32) * scale, dim=0)
    out = out.reshape(-1)[:n].reshape(xs.shape[1:])
    return out.unsqueeze(dim).expand(x.shape)


# ---------------------------------------------------------------------------
# rank forms: one position's block, moved by a communicator
# ---------------------------------------------------------------------------

def rank_ring_shift(x: torch.Tensor, comm, shift: int) -> torch.Tensor:
    """Send x to data index (d + shift) mod A; receive from (d - shift)."""
    return comm.shift(x, shift)


def rank_ring_xor_reduce(x: torch.Tensor, comm) -> torch.Tensor:
    """XOR of the column's blocks, on every rank: A - 1 steps, each a
    shift by one and an XOR (the reference's ``fori_loop``)."""
    return rank_ring_xor_reduce_(x.clone(), comm)


def rank_ring_xor_reduce_(acc: torch.Tensor, comm) -> torch.Tensor:
    """``rank_ring_xor_reduce`` into ``acc``, the rank's block, in place
    (no copy of the block)."""
    buf = acc
    for _ in range(comm.axis_size - 1):
        buf = comm.shift(buf, 1)
        acc ^= buf
    return acc


def rank_compressed_psum(x: torch.Tensor, comm, *, block: int = 256
                         ) -> torch.Tensor:
    """int8-quantized sum over the column (cross-pod gradient
    compression): the rank quantizes its block to int8 with per-block
    absmax scales, gathers every rank's payload and scales, and sums the
    dequantized blocks in data order."""
    shape = x.shape
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    qg = comm.all_gather(q)                         # (A, nb, block) int8
    sg = comm.all_gather(scale)                     # (A, nb, 1) fp32
    out = torch.sum(qg.to(torch.float32) * sg, dim=0)
    return out.reshape(-1)[:n].reshape(shape)
