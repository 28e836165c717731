"""GF(2^8) matrix products over stripes: CUDA kernels + plain torch.

Three entry points, with the JAX package's signatures:

* ``gf256_matmul(A, data)``: one host matrix A (m, k) times one stripe
  (k, C) -> (m, C), the single-stripe product of ``kernels/ops.py``
  (``encode_stripe``/``decode_stripe``).  Kernel ``gf_matmul`` replaces
  ``_gf_matmul_kernel``: the ``unroll`` body with B = 1.  A matrix the
  strategy rule sends elsewhere (above ``MAX_UNROLL_OPS``) runs the
  ``cols`` or ``gf01`` kernel as a batch of one, as the reference's
  single-stripe kernel handles any matrix.

* ``gf256_matmul_batched(A, data, strategy=None)``: one host matrix A
  (m, k) times a batch of stripes (B, k, C) -> (B, m, C).  Encode and the
  fused decode.  Three kernels in ``csrc/gf256.cu``, one per strategy of
  the JAX package's entry point, chosen by its rule (``choose_strategy``):

  - ``unroll``, m*k*8 <= ``MAX_UNROLL_OPS``: ``gf_matmul_batched``
    replaces ``_gf_matmul_batched_kernel`` (RS/XOR encode and decode);
  - ``gf01``, larger 0/1 matrices: ``gf01_matmul_batched`` replaces
    ``_gf01_matmul_kernel`` (RDP encode and decode, an XOR-select);
  - ``cols``, larger dense matrices: ``gf_matmul_cols_batched`` replaces
    ``_gf_matmul_cols_kernel`` (e.g. RS(14,10) decodes that re-encode
    three or four parities).

* ``gf256_matmul_per_item_batched(Ms, blocks, parity)``: one matrix per
  item, (B, O, J) times (B, J, C), XORed into ``parity`` (B, O, C) when
  given.  With parity, kernel ``gf_per_item_fold`` replaces
  ``_per_item_fold_kernel`` (seal folds, hot-key collapse, RDP sealed
  updates); without, ``gf_per_item`` replaces ``_per_item_kernel`` (RDP
  degraded mutates).

Bound: every kernel moves each input byte once and each output byte once
(at B=4096, C=4096, (10, 8) that is 302 MB against ~0.1 ms at 3.35 TB/s);
the arithmetic is a shared-memory lookup per product, or an XOR where the
coefficient is 1.  See the source note in ``csrc/gf256.cu`` for the
design.  The ``gf01`` and ``cols`` matrices are copied to the device once
per matrix and cached (``_device_matrix``): the encode matrix is fixed per
code and decode matrices recur per erasure pattern.

Dispatch (``kernels.dispatch``): a CUDA tensor launches the kernel, a
CPU tensor takes the plain version of the same strategy.  Nothing falls
back.  The JAX entry points' ``block_c``/``interpret`` arguments and the
tuner lookup have no counterpart yet.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build, dispatch

#: launches of each kernel by its wrapper (plain versions do not count)
LAUNCHES = {"gf_matmul_batched": 0, "gf_matmul_cols_batched": 0,
            "gf01_matmul_batched": 0, "gf_per_item": 0,
            "gf_per_item_fold": 0, "gf_matmul": 0}

#: the JAX package's rule: beyond this many fused ops (m*k*8) the unrolled
#: body gives way to the column-loop kernels
MAX_UNROLL_OPS = 1024
STRATEGIES = ("unroll", "cols", "gf01")
_KERNEL_OF = {"unroll": "gf_matmul_batched", "cols": "gf_matmul_cols_batched",
              "gf01": "gf01_matmul_batched"}

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


def choose_strategy(A: np.ndarray, strategy: str | None = None) -> str:
    """The kernel body for matrix ``A``, by the JAX package's rule
    (``gf256_matmul_batched`` there): a named strategy is kept, except
    that ``gf01`` on a matrix with a coefficient above 1 becomes
    ``cols``; otherwise ``unroll`` up to ``MAX_UNROLL_OPS`` fused ops,
    then ``gf01`` for 0/1 matrices and ``cols`` for the rest."""
    m, k = A.shape
    zero_one = int(A.max(initial=0)) <= 1
    if strategy not in STRATEGIES:
        strategy = ("unroll" if m * k * 8 <= MAX_UNROLL_OPS
                    else "gf01" if zero_one else "cols")
    if strategy == "gf01" and not zero_one:
        strategy = "cols"
    return strategy


def _pack_rows(A: np.ndarray) -> np.ndarray:
    """0/1 (M, K) matrix -> (M, ceil(K/32)) uint32 row masks, bit j % 32 of
    word j // 32 set where A[o, j] = 1 (the ``gf01`` kernel's layout)."""
    M, K = A.shape
    words = -(-K // 32)
    packed = np.zeros((M, words * 4), dtype=np.uint8)
    packed[:, :-(-K // 8)] = np.packbits(A.astype(bool), axis=1,
                                         bitorder="little")
    return packed.view("<u4")


@_build.locked_cache(maxsize=512)
def _device_matrix(strategy: str, raw: bytes, shape: tuple,
                   device: torch.device) -> torch.Tensor:
    A = np.frombuffer(raw, dtype=np.uint8).reshape(shape).copy()
    host = _pack_rows(A).view(np.int32) if strategy == "gf01" else A
    return torch.from_numpy(host).to(device)


# ---------------------------------------------------------------------------
# plain torch versions (any device)
# ---------------------------------------------------------------------------

def gf256_matmul_batched_plain(A, data: torch.Tensor) -> torch.Tensor:
    """(m, k) x (B, k, C) -> (B, m, C): per input i, gather the products
    of column A[:, i] with every byte from the MUL table rows, XOR-fold.
    The plain version of the ``unroll`` and ``cols`` kernels."""
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


def gf256_matmul_plain(A, data: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, C) -> (m, C): the batched plain version on a batch of
    one.  The plain version of the ``gf_matmul`` kernel."""
    return gf256_matmul_batched_plain(A, data[None])[0]


def gf01_matmul_batched_plain(A, data: torch.Tensor) -> torch.Tensor:
    """0/1 (m, k) x (B, k, C) -> (B, m, C) as an XOR-select: per input i,
    XOR data[:, i] into the output rows whose coefficient is 1.  The
    plain version of the ``gf01`` kernel."""
    A = np.asarray(A, dtype=np.uint8)
    m, k = A.shape
    B, kd, C = data.shape
    if kd != k:
        raise ValueError(f"data {tuple(data.shape)} does not match A {(m, k)}")
    if int(A.max(initial=0)) > 1:
        raise ValueError("the gf01 product needs a 0/1 matrix")
    out = torch.zeros((B, m, C), dtype=torch.uint8, device=data.device)
    for i in range(k):
        rows = np.flatnonzero(A[:, i])
        if B and rows.size:
            idx = torch.from_numpy(rows).to(data.device)
            out[:, idx] ^= data[:, i:i + 1]
    return out


def gf256_matmul_per_item_plain(Ms, blocks: torch.Tensor,
                                parity: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """(B, O, J) x (B, J, C) [^ parity (B, O, C)] -> (B, O, C): per input
    j, index the flat MUL table with Ms[b, o, j] * 256 + byte.  The plain
    version of both per-item kernels."""
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

def gf256_matmul_batched(A, data: torch.Tensor,
                         strategy: str | None = None) -> torch.Tensor:
    """Batched A (*) data over GF(2^8): (m, k) host matrix, (B, k, C) uint8
    tensor -> (B, m, C) on the data's device.  ``strategy`` names the
    kernel body (``unroll``/``gf01``/``cols``); by default, and for a
    name it does not know, ``choose_strategy`` picks it."""
    A = np.ascontiguousarray(np.asarray(A, dtype=np.uint8))
    if A.ndim != 2:
        raise ValueError(f"A must be (m, k), got {A.shape}")
    m, k = A.shape
    if not isinstance(data, torch.Tensor) or data.dim() != 3:
        raise ValueError("data must be a (B, k, C) torch.Tensor")
    B, _, C = data.shape
    strategy = choose_strategy(A, strategy)
    if not dispatch.decide(data).kernel:
        if strategy == "gf01":
            return gf01_matmul_batched_plain(A, data)
        return gf256_matmul_batched_plain(A, data)
    dev = data.device
    _build.require(data, "data", torch.uint8, (B, k, C), dev)
    out = torch.empty((B, m, C), dtype=torch.uint8, device=dev)
    if B == 0 or m == 0 or k == 0 or C == 0:
        return out.zero_()
    lib = _build.library()
    name = _KERNEL_OF[strategy]
    with torch.cuda.device(dev):
        if strategy == "unroll":
            if m * k > lib.gf_max_coefs():
                raise ValueError(f"matrix {(m, k)} exceeds the unroll "
                                 f"kernel's {lib.gf_max_coefs()} coefficients")
            err = lib.gf_matmul_batched(
                A.ctypes.data, m, k, _build.tables(dev).data_ptr(),
                data.data_ptr(), out.data_ptr(), B, C, _build.stream_ptr(dev))
        elif strategy == "gf01":
            if k > lib.gf01_max_cols():
                raise ValueError(f"matrix {(m, k)} exceeds the gf01 "
                                 f"kernel's {lib.gf01_max_cols()} columns")
            masks = _device_matrix("gf01", A.tobytes(), A.shape, dev)
            err = lib.gf01_matmul_batched(
                masks.data_ptr(), m, k, data.data_ptr(), out.data_ptr(), B, C,
                _build.stream_ptr(dev))
        else:
            if m * k > lib.gf_cols_max_coefs():
                raise ValueError(f"matrix {(m, k)} exceeds the cols "
                                 f"kernel's {lib.gf_cols_max_coefs()} "
                                 f"coefficients")
            a_dev = _device_matrix("cols", A.tobytes(), A.shape, dev)
            err = lib.gf_matmul_cols_batched(
                _build.tables(dev).data_ptr(), a_dev.data_ptr(), m, k,
                data.data_ptr(), out.data_ptr(), B, C, _build.stream_ptr(dev))
    _build.check(err, name)
    _build.count_launch(LAUNCHES, name)
    return out


def gf256_matmul(A, data: torch.Tensor) -> torch.Tensor:
    """Single-stripe A (*) data over GF(2^8): (m, k) host matrix, (k, C)
    uint8 tensor -> (m, C) on the data's device."""
    A = np.ascontiguousarray(np.asarray(A, dtype=np.uint8))
    if A.ndim != 2:
        raise ValueError(f"A must be (m, k), got {A.shape}")
    m, k = A.shape
    if not isinstance(data, torch.Tensor) or data.dim() != 2:
        raise ValueError("data must be a (k, C) torch.Tensor")
    C = data.shape[1]
    strategy = choose_strategy(A)
    if strategy != "unroll" or not dispatch.decide(data).kernel:
        # the batch-of-one path: another kernel body, or a plain version
        return gf256_matmul_batched(A, data[None], strategy)[0]
    dev = data.device
    _build.require(data, "data", torch.uint8, (k, C), dev)
    out = torch.empty((m, C), dtype=torch.uint8, device=dev)
    if m == 0 or k == 0 or C == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gf_matmul(A.ctypes.data, m, k, _build.tables(dev).data_ptr(),
                            data.data_ptr(), out.data_ptr(), C,
                            _build.stream_ptr(dev))
    _build.check(err, "gf_matmul")
    _build.count_launch(LAUNCHES, "gf_matmul")
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
    if parity is not None:
        _build.require(parity, "parity", torch.uint8, (B, O, C), dev)
    out = torch.empty((B, O, C), dtype=torch.uint8, device=dev)
    if B == 0 or O == 0 or J == 0 or C == 0:
        return out.copy_(parity) if parity is not None else out.zero_()
    ms_dev = torch.from_numpy(Ms).to(dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        if parity is None:
            err = lib.gf_per_item(
                _build.tables(dev).data_ptr(), ms_dev.data_ptr(),
                blocks.data_ptr(), out.data_ptr(), B, O, J, C,
                _build.stream_ptr(dev))
            name = "gf_per_item"
        else:
            err = lib.gf_per_item_fold(
                _build.tables(dev).data_ptr(), ms_dev.data_ptr(),
                parity.data_ptr(), blocks.data_ptr(), out.data_ptr(),
                B, O, J, C, _build.stream_ptr(dev))
            name = "gf_per_item_fold"
    _build.check(err, name)
    _build.count_launch(LAUNCHES, name)
    return out
