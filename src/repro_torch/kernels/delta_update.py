"""Batched parity deltas  P' = P ⊕ gamma·(D ⊕ D'): CUDA kernels + plain torch.

This is the paper's UPDATE hot path (§2/§4.2): every sealed update folds
gamma[b, r]·xor[b] into the m parity rows of its stripe.

* ``delta_apply_batched(parity, gammas, xor)``: (B, m, C) parity,
  (B, m) gammas, (B, C) xor -> (B, m, C) updated parity.  Kernel
  ``gf_delta_apply_batched`` in ``csrc/gf256.cu`` replaces
  ``kernels/delta_update.py:_delta_apply_batched_kernel``.
* ``delta_apply_batched(None, gammas, xor)``: the bare deltas, no parity
  streams.  Kernel ``gf_delta_only_batched`` replaces
  ``_delta_only_batched_kernel``.  Both are one templated kernel with a
  ``HAS_PARITY`` flag.
* ``delta_apply_per_item_batched``: the front door for per-item matrices
  (seal folds, hot-key collapse, every RDP delta), routed to
  ``gf256_matmul_per_item_batched``: with parity its fold kernel, with
  ``parity=None`` its plain per-item kernel.

Bound: device-memory bytes, (2m+1)·C per item with parity and (m+1)·C
without; the kernel reads the xor once, takes its log once per byte, and
spends one EXP lookup per output byte (see ``csrc/gf256.cu``).

Dispatch: a CUDA tensor launches the kernel, a CPU tensor takes the plain
version below.  Nothing falls back.
"""
from __future__ import annotations

import torch

from . import _build, dispatch
from .gf256_matmul import _batch_chunks, _mul_flat, gf256_matmul_per_item_batched

#: launches of each kernel by its wrapper (plain versions do not count)
LAUNCHES = {"gf_delta_apply_batched": 0, "gf_delta_only_batched": 0}


def delta_apply_batched_plain(parity: torch.Tensor | None, gammas,
                              xor: torch.Tensor) -> torch.Tensor:
    """(B, m) gammas times (B, C) xor -> (B, m, C) deltas, XORed into
    ``parity`` when given; one gather from the flat MUL table."""
    dev = xor.device
    g = torch.as_tensor(gammas).to(device=dev, dtype=torch.int64) & 255
    B, m = g.shape
    C = xor.shape[1]
    out = (parity.clone() if parity is not None
           else torch.zeros((B, m, C), dtype=torch.uint8, device=dev))
    if B == 0 or m == 0:
        return out
    mul = _mul_flat(dev)
    for s, e in _batch_chunks(B, m * C):
        idx = (g[s:e] * 256)[:, :, None] + xor[s:e].long()[:, None, :]
        out[s:e] ^= mul[idx]
    return out


def delta_apply_batched(parity: torch.Tensor | None, gammas,
                        xor: torch.Tensor) -> torch.Tensor:
    """Batched fused delta fold with per-item coefficients.

    parity: (B, m, C) or None; gammas: (B, m) int32 (host array or
    tensor); xor: (B, C) uint8, D ⊕ D' per item.  Returns (B, m, C) on
    the xor's device: updated parity, or the bare deltas for
    ``parity=None``."""
    if not isinstance(xor, torch.Tensor) or xor.dim() != 2:
        raise ValueError("xor must be a (B, C) torch.Tensor")
    if not dispatch.decide(xor).kernel:
        return delta_apply_batched_plain(parity, gammas, xor)
    dev = xor.device
    B, C = xor.shape
    g = torch.as_tensor(gammas).to(device=dev, dtype=torch.int32).contiguous()
    if g.dim() != 2 or g.shape[0] != B:
        raise ValueError(f"gammas {tuple(g.shape)} vs xor {(B, C)}")
    m = g.shape[1]
    _build.require(xor, "xor", torch.uint8, (B, C), dev)
    if parity is not None:
        _build.require(parity, "parity", torch.uint8, (B, m, C), dev)
    out = torch.empty((B, m, C), dtype=torch.uint8, device=dev)
    if B == 0 or m == 0 or C == 0:
        return out.copy_(parity) if parity is not None else out.zero_()
    lib = _build.library()
    with torch.cuda.device(dev):
        if parity is None:
            err = lib.gf_delta_only_batched(
                _build.tables(dev).data_ptr(), g.data_ptr(), xor.data_ptr(),
                out.data_ptr(), B, m, C, _build.stream_ptr(dev))
            name = "gf_delta_only_batched"
        else:
            err = lib.gf_delta_apply_batched(
                _build.tables(dev).data_ptr(), g.data_ptr(),
                parity.data_ptr(), xor.data_ptr(), out.data_ptr(), B, m, C,
                _build.stream_ptr(dev))
            name = "gf_delta_apply_batched"
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def delta_apply_per_item_batched(parity: torch.Tensor | None, Ms,
                                 blocks: torch.Tensor) -> torch.Tensor:
    """Per-item-matrix delta fold: ``Ms`` (B, O, J) host matrices,
    ``blocks`` (B, J, C), ``parity`` (B, O, C) folded in when given; for
    ``parity=None`` the bare (B, O, C) deltas.  The dispatch-routed front
    door for ``gf256_matmul_per_item_batched``; the tuner lookup of the
    JAX package comes with the tuner."""
    return gf256_matmul_per_item_batched(Ms, blocks, parity)
