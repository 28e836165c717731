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
(at B=4096, C=4096, (10, 8) that is 302 MB against ~0.09 ms at 3.35
TB/s).  The ``unroll`` and ``cols`` kernels (and ``gf_matmul``) take the
shared matrix as its coefficients' nibble tables, the ``gf01`` kernel as
its rows' bit masks, built on the host once per matrix
(``coefs.matrix_tables``/``matrix_masks``, cached by the matrix's bytes
with the strategy in ``_plan``: the encode matrix is fixed per code and
the fused decode matrices recur per erasure pattern) and passed by value
in the launch parameters, so those calls copy nothing to the card and
never wait on the stream.  Only a matrix above the largest parameter
tier (a ``cols`` matrix of more than 1,360 coefficients, a ``gf01`` one
of more than 8,160 mask words) has its words copied to the card, once
per matrix, and cached (``_device_matrix``).  The per-item matrices
change with every call, so they travel by value too
(``kernels/coefs.py``): as bytes, or for 0/1 matrices as row masks.  See
the source notes in ``csrc/gf256.cu`` for the designs.

Dispatch (``kernels.dispatch``): a CUDA tensor launches the kernel, a
CPU tensor runs ``cpu_gf256``, the counterpart of the reference's XLA
formulations.  Nothing falls back.  A strategy left unnamed comes from
the tuning cache (``kernels/tune.py``) where it has an entry for the
call's path and shape, else from the built-in rule, as in the reference.
The JAX entry points' ``block_c``/``interpret`` arguments have no
counterpart.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, coefs, cpu_gf256, dispatch

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


def _words(strategy: str, A: np.ndarray) -> np.ndarray:
    """A matrix as its kernel reads it: the ``gf01`` row masks, or the
    nibble tables of an ``unroll`` or ``cols`` matrix (uint32 words)."""
    return (coefs.matrix_masks(A) if strategy == "gf01"
            else coefs.matrix_tables(A))


@_build.locked_cache(maxsize=512)
def _device_matrix(strategy: str, raw: bytes, shape: tuple,
                   device: torch.device) -> torch.Tensor:
    """The words of a matrix above the largest parameter tier on the
    card, copied once."""
    A = np.frombuffer(raw, dtype=np.uint8).reshape(shape)
    host = _words(strategy, A).view(np.int32)
    return torch.from_numpy(host.copy()).to(device)


@functools.lru_cache(maxsize=512)
def _plan(raw: bytes, shape: tuple, strategy: str | None) -> tuple:
    """(strategy, words, tier, nnz) of one matrix on the card, cached per
    matrix: ``choose_strategy``'s answer, the kernel's words as bytes
    (``_words``) with the parameter tier they fit, and the matrix's
    nonzero count (the ``gf01`` kernel picks its body by it).  Above the
    largest tier the words are (None, ``coefs.DEVICE``): they are built
    for the card alone (``_device_matrix``)."""
    A = np.frombuffer(raw, dtype=np.uint8).reshape(shape)
    strategy = choose_strategy(A, strategy)
    words = _words(strategy, A)
    tier = coefs.matrix_tier(words.nbytes)
    return (strategy, None if tier == coefs.DEVICE else words.tobytes(),
            tier, int(np.count_nonzero(A)))


@functools.cache
def _limits() -> dict:
    """The kernels' matrix limits, read from the library once."""
    lib = _build.library()
    return {"unroll": lib.gf_max_coefs(), "cols": lib.gf_cols_max_coefs(),
            "gf01": lib.gf01_max_cols()}


def _host_matrix(A) -> np.ndarray:
    A = np.ascontiguousarray(A, dtype=np.uint8)
    if A.ndim != 2:
        raise ValueError(f"A must be (m, k), got {A.shape}")
    return A


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
# wrappers: CUDA tensors -> kernel, CPU tensors -> cpu_gf256
# ---------------------------------------------------------------------------

_tune = None       # kernels.tune, imported at the first lookup


def _tuned(op: str, path: str, A, *, chunk: int,
           batch: int) -> str | None:
    """The tuning cache's strategy for a call with matrix (or per-item
    matrices) ``A``, or None."""
    global _tune
    tune = _tune
    if tune is None:
        # not at import: ``python -m repro_torch.kernels.tune`` runs it
        from . import tune
        _tune = tune
    if not tune.active(op, path):
        return None
    A = np.asarray(A, dtype=np.uint8)
    m, k = A.shape[-2:]
    entry = tune.lookup(op, path, k=k, m=m, chunk=chunk, batch=batch,
                        cls=tune.matrix_cls(A))
    return entry.get("strategy") if entry else None


def _cpu_strategy(strategy: str | None) -> str | None:
    return strategy if strategy in cpu_gf256.STRATEGIES else None


@torch.library.custom_op("repro_torch::gf256_product", mutates_args=(),
                         device_types="cpu")
def _meta_product(data: torch.Tensor, m: int) -> torch.Tensor:
    """The shared-matrix product's output shape (B, m, C) for a dry run:
    one op that reads ``data`` and writes the output, as the kernel does
    (``launch/cost_analysis.py`` counts its bytes).  Only its fake
    implementation ever runs, on meta tensors."""
    raise RuntimeError("gf256_product gives shapes only (meta tensors)")


@_meta_product.register_fake
def _meta_product_shape(data, m):
    return data.new_empty((data.shape[0], m, data.shape[2]))


def gf256_matmul_batched(A, data: torch.Tensor,
                         strategy: str | None = None) -> torch.Tensor:
    """Batched A (*) data over GF(2^8): (m, k) host matrix, (B, k, C) uint8
    tensor -> (B, m, C) on the data's device.  ``strategy`` names the
    kernel body (``unroll``/``gf01``/``cols``), or on the CPU the
    ``cpu_gf256`` formulation; by default the tuning cache's entry for
    the shape, else (and for a name the path does not know)
    ``choose_strategy`` or ``cpu_gf256.default_strategy``.  On the card one
    call is one launch.  The matrix's tables or row masks go into the
    launch parameters, so the call copies nothing to the card and does
    not synchronize; only a matrix above the largest parameter tier is
    copied to the card at its first call (a pageable copy, which waits on
    the stream) and cached."""
    A = _host_matrix(A)
    m, k = A.shape
    if not isinstance(data, torch.Tensor) or data.dim() != 3:
        raise ValueError("data must be a (B, k, C) torch.Tensor")
    B, _, C = data.shape
    path = dispatch.decide(data).path
    if path == dispatch.META:
        return torch.ops.repro_torch.gf256_product(data, m)
    if strategy is None and B and m:
        strategy = _tuned("matmul", path, A, chunk=C, batch=B)
    if path != dispatch.CUDA:
        return cpu_gf256.matmul_batched(A, data,
                                        strategy=_cpu_strategy(strategy))
    raw = A.tobytes()
    strategy, words, tier, nnz = _plan(raw, A.shape, strategy)
    dev = data.device
    _build.require(data, "data", torch.uint8, (B, k, C), dev)
    out = torch.empty((B, m, C), dtype=torch.uint8, device=dev)
    if B == 0 or m == 0 or k == 0 or C == 0:
        return out.zero_()
    limit = _limits()[strategy]
    if (k if strategy == "gf01" else m * k) > limit:
        raise ValueError(f"matrix {(m, k)} exceeds the {strategy} kernel's "
                         f"{limit} " + ("columns" if strategy == "gf01"
                                        else "coefficients"))
    lib = _build.library()
    name = _KERNEL_OF[strategy]
    if tier == coefs.DEVICE:
        words = _device_matrix(strategy, raw, A.shape, dev).data_ptr()
    with _build.on_device(dev):
        stream = _build.stream_ptr(dev)
        if strategy == "gf01":
            err = lib.gf01_matmul_batched(tier, words, m, k, nnz,
                                          data.data_ptr(), out.data_ptr(), B,
                                          C, stream)
        else:
            fn = (lib.gf_matmul_batched if strategy == "unroll"
                  else lib.gf_matmul_cols_batched)
            err = fn(tier, words, m, k, data.data_ptr(), out.data_ptr(), B, C,
                     stream)
    _build.check(err, name)
    _build.count_launch(LAUNCHES, name)
    return out


def gf256_matmul(A, data: torch.Tensor,
                 strategy: str | None = None) -> torch.Tensor:
    """Single-stripe A (*) data over GF(2^8): (m, k) host matrix, (k, C)
    uint8 tensor -> (m, C) on the data's device.  The strategy is
    chosen as the batched wrapper's, from the cache's batch-1 entry: an
    ``unroll`` matrix runs kernel ``gf_matmul`` (its tables by value, as
    the batched wrapper's); any other a batch of one."""
    A = _host_matrix(A)
    m, k = A.shape
    if not isinstance(data, torch.Tensor) or data.dim() != 2:
        raise ValueError("data must be a (k, C) torch.Tensor")
    C = data.shape[1]
    path = dispatch.decide(data).path
    if strategy is None and m:
        strategy = _tuned("matmul", path, A, chunk=C, batch=1)
    if path != dispatch.CUDA:
        return cpu_gf256.matmul(A, data, strategy=_cpu_strategy(strategy))
    strategy, tabs, tier, _ = _plan(A.tobytes(), A.shape, strategy)
    if strategy != "unroll":
        # the batch-of-one path: another kernel body
        return gf256_matmul_batched(A, data[None], strategy)[0]
    dev = data.device
    _build.require(data, "data", torch.uint8, (k, C), dev)
    out = torch.empty((m, C), dtype=torch.uint8, device=dev)
    if m == 0 or k == 0 or C == 0:
        return out.zero_()
    lib = _build.library()
    with _build.on_device(dev):
        err = lib.gf_matmul(tier, tabs, m, k, data.data_ptr(), out.data_ptr(),
                            C, _build.stream_ptr(dev))
    _build.check(err, "gf_matmul")
    _build.count_launch(LAUNCHES, "gf_matmul")
    return out


def per_item_host(Ms: np.ndarray, strategy: str | None) -> tuple:
    """(mask bytes per row, host coefficients) of a per-item batch on the
    card: ``cols`` takes the bytes; any other strategy the
    ``coefs.per_item_coefs`` rule (row masks for 0/1 matrices with J <=
    32, the ``gf01`` form)."""
    if strategy == "cols":
        return 0, np.ascontiguousarray(Ms)
    return coefs.per_item_coefs(Ms)


def gf256_matmul_per_item_batched(Ms, blocks: torch.Tensor,
                                  parity: torch.Tensor | None = None,
                                  strategy: str | None = None
                                  ) -> torch.Tensor:
    """Per-item matrices: (B, O, J) host matrices (a tensor is read back
    to the host first, which waits on its stream), (B, J, C) uint8 tensor
    -> (B, O, C), with ``parity`` (B, O, C) XORed in when given.  On the
    card the matrices go into the launch parameters in the form
    ``per_item_host`` gives for ``strategy``, so the call copies nothing
    to the card and does not synchronize; a batch whose matrices exceed
    the largest parameter tier runs as several launches.  On the CPU
    ``strategy`` names the ``cpu_gf256`` formulation."""
    if isinstance(Ms, torch.Tensor):
        Ms = Ms.cpu().numpy()
    Ms = np.asarray(Ms, dtype=np.uint8)
    if Ms.ndim != 3:
        raise ValueError(f"Ms must be (B, O, J), got {Ms.shape}")
    B, O, J = Ms.shape
    if not isinstance(blocks, torch.Tensor) or blocks.dim() != 3:
        raise ValueError("blocks must be a (B, J, C) torch.Tensor")
    C = blocks.shape[2]
    if not dispatch.decide(blocks).kernel:
        return cpu_gf256.matmul_per_item(Ms, blocks, parity,
                                         strategy=_cpu_strategy(strategy))
    dev = blocks.device
    _build.require(blocks, "blocks", torch.uint8, (B, J, C), dev)
    if parity is not None:
        _build.require(parity, "parity", torch.uint8, (B, O, C), dev)
    out = (torch.empty((B, O, C), dtype=torch.uint8, device=dev)
           if parity is None else torch.empty_like(parity))
    if B == 0 or O == 0 or J == 0 or C == 0:
        return out.copy_(parity) if parity is not None else out.zero_()
    mb, host = per_item_host(Ms, strategy)
    per_item = host.size // B
    # host bytes go to ctypes as a char pointer, cheaper than .ctypes.data
    hb = host.tobytes()
    lib = _build.library()
    name = "gf_per_item" if parity is None else "gf_per_item_fold"
    d_ptr, o_ptr = blocks.data_ptr(), out.data_ptr()
    with _build.on_device(dev):
        stream = _build.stream_ptr(dev)
        for s, e, tier in coefs.plan_launches(B, per_item):
            h = hb[s * per_item:e * per_item]
            if parity is None:
                err = lib.gf_per_item(
                    tier, h, mb, d_ptr + s * J * C, o_ptr + s * O * C,
                    e - s, O, J, C, stream)
            else:
                err = lib.gf_per_item_fold(
                    tier, h, mb, parity.data_ptr() + s * O * C,
                    d_ptr + s * J * C, o_ptr + s * O * C, e - s, O, J, C,
                    stream)
            _build.check(err, name)
            _build.count_launch(LAUNCHES, name)
    return out
