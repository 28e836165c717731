"""GF(2^8) matrix products over a batch of stripes: CUDA kernels + plain torch.

Two entry points, with the JAX package's signatures:

* ``gf256_matmul_batched(A, data)``: one host matrix A (m, k) times a
  batch of stripes (B, k, C) -> (B, m, C).  Encode and the fused decode
  of RS/XOR codes.  Kernel ``gf_matmul_batched`` in ``csrc/gf256.cu``
  replaces ``kernels/gf256_matmul.py:_gf_matmul_batched_kernel`` (the
  ``unroll`` strategy) of the JAX package.
* ``gf256_matmul_per_item_batched(Ms, blocks, parity)``: one matrix per
  item, (B, O, J) times (B, J, C), XORed into ``parity`` (B, O, C).  The
  seal fold (B, 1, 1) and the hot-key collapse (B, m, 1).  Kernel
  ``gf_per_item_fold`` replaces ``_per_item_fold_kernel``.

Bound: both move each input byte once and each output byte once (at
B=4096, C=4096, (10, 8) that is 302 MB against ~0.1 ms at 3.35 TB/s);
the arithmetic is one shared-memory lookup per product.  See the
source note in ``csrc/gf256.cu`` for the design.

Dispatch (``kernels.dispatch``): a CUDA tensor launches the kernel, a
CPU tensor takes the plain version below.  Nothing falls back.  The
JAX entry points' ``strategy``/``block_c``/``interpret`` arguments have
no counterpart: one kernel body per entry point, no tuner yet.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build, dispatch

#: launches of each kernel by its wrapper (plain versions do not count)
LAUNCHES = {"gf_matmul_batched": 0, "gf_per_item_fold": 0}

# plain versions gather through int64 index tensors; keep each chunk's
# index tensor near this many elements
_CHUNK_ELEMS = 1 << 22


def _mul_flat(device) -> torch.Tensor:
    from ..core import gf256
    return gf256.device_tables(device)[2]


def _batch_chunks(B: int, per_item: int):
    step = max(1, _CHUNK_ELEMS // max(1, per_item))
    for s in range(0, B, step):
        yield s, min(B, s + step)


# ---------------------------------------------------------------------------
# plain torch versions (any device)
# ---------------------------------------------------------------------------

def gf256_matmul_batched_plain(A, data: torch.Tensor) -> torch.Tensor:
    """(m, k) x (B, k, C) -> (B, m, C): per input i, gather the products
    of column A[:, i] with every byte from the MUL table rows, XOR-fold."""
    A = torch.from_numpy(np.array(A, dtype=np.uint8)).to(data.device)
    m, k = A.shape
    B, kd, C = data.shape
    if kd != k:
        raise ValueError(f"data {tuple(data.shape)} does not match A {(m, k)}")
    out = torch.zeros((B, m, C), dtype=torch.uint8, device=data.device)
    if B == 0 or m == 0:
        return out
    mul = _mul_flat(data.device).view(256, 256)
    for s, e in _batch_chunks(B, C):
        acc = torch.zeros((m, (e - s) * C), dtype=torch.uint8,
                          device=data.device)
        for i in range(k):
            rows = mul[A[:, i].long()]                         # (m, 256)
            acc ^= torch.index_select(rows, 1,
                                      data[s:e, i].reshape(-1).long())
        out[s:e] = acc.view(m, e - s, C).permute(1, 0, 2)
    return out


def gf256_matmul_per_item_plain(Ms, blocks: torch.Tensor,
                                parity: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """(B, O, J) x (B, J, C) [^ parity (B, O, C)] -> (B, O, C): per input
    j, index the flat MUL table with Ms[b, o, j] * 256 + byte."""
    dev = blocks.device
    Ms = torch.from_numpy(np.array(Ms, dtype=np.uint8)).to(dev)
    B, O, J = Ms.shape
    C = blocks.shape[2]
    if tuple(blocks.shape[:2]) != (B, J):
        raise ValueError(f"blocks {tuple(blocks.shape)} vs Ms {(B, O, J)}")
    out = (parity.clone() if parity is not None
           else torch.zeros((B, O, C), dtype=torch.uint8, device=dev))
    if B == 0 or O == 0:
        return out
    mul = _mul_flat(dev)
    for s, e in _batch_chunks(B, O * C):
        for j in range(J):
            idx = (Ms[s:e, :, j].long() * 256)[:, :, None] \
                + blocks[s:e, j].long()[:, None, :]           # (b, O, C)
            out[s:e] ^= mul[idx]
    return out


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors -> kernel, CPU tensors -> plain version
# ---------------------------------------------------------------------------

def gf256_matmul_batched(A, data: torch.Tensor) -> torch.Tensor:
    """Batched A (*) data over GF(2^8): (m, k) host matrix, (B, k, C) uint8
    tensor -> (B, m, C) on the data's device."""
    A = np.ascontiguousarray(np.asarray(A, dtype=np.uint8))
    if A.ndim != 2:
        raise ValueError(f"A must be (m, k), got {A.shape}")
    m, k = A.shape
    if not isinstance(data, torch.Tensor) or data.dim() != 3:
        raise ValueError("data must be a (B, k, C) torch.Tensor")
    B, _, C = data.shape
    if not dispatch.decide(data).kernel:
        return gf256_matmul_batched_plain(A, data)
    dev = data.device
    _build.require(data, "data", torch.uint8, (B, k, C), dev)
    out = torch.empty((B, m, C), dtype=torch.uint8, device=dev)
    if B == 0 or m == 0 or k == 0 or C == 0:
        return out.zero_()
    lib = _build.library()
    if m * k > lib.gf_max_coefs():
        raise ValueError(f"matrix {(m, k)} exceeds the kernel's "
                         f"{lib.gf_max_coefs()} coefficients")
    with torch.cuda.device(dev):
        err = lib.gf_matmul_batched(
            A.ctypes.data, m, k, _build.tables(dev).data_ptr(),
            data.data_ptr(), out.data_ptr(), B, C, _build.stream_ptr(dev))
    _build.check(err, "gf_matmul_batched")
    LAUNCHES["gf_matmul_batched"] += 1
    return out


def gf256_matmul_per_item_batched(Ms, blocks: torch.Tensor,
                                  parity: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """Per-item matrices: (B, O, J) host matrices, (B, J, C) uint8 tensor
    -> (B, O, C), with ``parity`` (B, O, C) XORed in when given."""
    Ms = np.ascontiguousarray(np.asarray(Ms, dtype=np.uint8))
    if Ms.ndim != 3:
        raise ValueError(f"Ms must be (B, O, J), got {Ms.shape}")
    B, O, J = Ms.shape
    if not isinstance(blocks, torch.Tensor) or blocks.dim() != 3:
        raise ValueError("blocks must be a (B, J, C) torch.Tensor")
    C = blocks.shape[2]
    if not dispatch.decide(blocks).kernel:
        return gf256_matmul_per_item_plain(Ms, blocks, parity)
    dev = blocks.device
    _build.require(blocks, "blocks", torch.uint8, (B, J, C), dev)
    if parity is None:
        raise NotImplementedError(
            "the per-item product without a parity fold "
            "(_per_item_kernel, the RDP delta) is not ported yet: "
            "ROADMAP slice 2")
    _build.require(parity, "parity", torch.uint8, (B, O, C), dev)
    out = torch.empty((B, O, C), dtype=torch.uint8, device=dev)
    if B == 0 or O == 0 or J == 0 or C == 0:
        return out.copy_(parity)
    ms_dev = torch.from_numpy(Ms).to(dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gf_per_item_fold(
            _build.tables(dev).data_ptr(), ms_dev.data_ptr(),
            parity.data_ptr(), blocks.data_ptr(), out.data_ptr(),
            B, O, J, C, _build.stream_ptr(dev))
    _build.check(err, "gf_per_item_fold")
    LAUNCHES["gf_per_item_fold"] += 1
    return out
