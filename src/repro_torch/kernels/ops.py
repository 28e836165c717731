"""Public single-stripe entry points over the kernels.

Every op runs the hand-written CUDA kernel for tensors on the card and
its plain torch version for tensors on the CPU; ``use_ref=True`` routes
to the torch oracles of ``ref`` instead (tests cross-validate with it).

Inputs may be numpy arrays or tensors.  A tensor's device decides where
the call runs; a numpy input goes to ``device``, the card by default
(with no card that raises: pass ``device="cpu"``).  Host work stays on
the host, as in the JAX package: the decode matrix inversion
(``code.decode_matrix``), key hashing and the bucket ids ``h % B``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import gf256
from ..core.codes import RSCode
from . import dispatch
from . import ref as _ref
from .cuckoo_lookup import cuckoo_lookup
from .delta_update import delta_update
from .gf256_matmul import gf256_matmul


def _u8(x, device) -> torch.Tensor:
    """``x`` as a contiguous uint8 tensor: a tensor where it lies, a host
    array on ``device`` (the card unless the caller says otherwise)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.uint8).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(
        dispatch.resolve_device(device))


def encode_stripe(code: RSCode, data, *, use_ref: bool = False,
                  device=None) -> torch.Tensor:
    """(k, C) data chunks -> (m, C) parity chunks."""
    data = _u8(data, device)
    A = code.parity_matrix
    if use_ref:
        return _ref.rs_encode_ref(A, data)
    return gf256_matmul(A, data)


def decode_stripe(code: RSCode, available: dict, wanted: list[int],
                  chunk_size: int, *, use_ref: bool = False,
                  device=None) -> dict[int, torch.Tensor]:
    """Reconstruct stripe positions from any k available chunks.

    The (k,k) decode-matrix inversion runs on the host (failure sets are
    concrete coordinator events); the (k,k)x(k,C) products run on the
    device of the chunks.
    """
    inv, idx = code.decode_matrix(list(available.keys()))
    stacked = torch.stack([_u8(available[i], device) for i in idx])
    if use_ref:
        mm = _ref.rs_decode_ref
    else:
        def mm(M, D):
            return gf256_matmul(np.asarray(M), D)
    data = mm(inv, stacked)
    out = {}
    G = code.generator
    need_par = [w for w in wanted if w >= code.k]
    for w in wanted:
        if w < code.k:
            out[w] = data[w]
    if need_par:
        par = mm(G[need_par], data)
        for r, w in enumerate(need_par):
            out[w] = par[r]
    return out


def apply_parity_delta(code: RSCode, parity, data_index: int, old, new, *,
                       use_ref: bool = False, device=None) -> torch.Tensor:
    """Fused P' = P ⊕ gamma_i (old ⊕ new) for all m parity rows."""
    parity = _u8(parity, device)
    old, new = _u8(old, parity.device), _u8(new, parity.device)
    gammas = code.parity_matrix[:, data_index].astype(np.int32)
    if use_ref:
        return _ref.delta_update_ref(parity, torch.from_numpy(gammas), old,
                                     new)
    return delta_update(parity, gammas, old, new)


def batched_index_lookup(index, keys: list[bytes], *, use_ref: bool = False,
                         device=None):
    """Probe a CuckooIndex for many keys at once on the device.

    Returns (found bool (Q,), slot int32 (Q,)).  Fingerprint equality is
    exact at the table level; callers resolve the slot to the stored
    entry.  The index lives on the host, so its arrays travel to
    ``device`` (the card by default) on every call.
    """
    from ..core.index import hash_pair
    fps, occ = index.bucket_arrays()
    h1s, h2s, qs = [], [], []
    for key in keys:
        h1, h2 = hash_pair(key)
        h1s.append(h1)
        h2s.append(h2)
        qs.append(h1 if h1 != 0 else 1)
    h1a = np.array(h1s, dtype=np.uint64)
    h2a = np.array(h2s, dtype=np.uint64)
    fpa = np.array(qs, dtype=np.uint64)
    if use_ref:
        dev = dispatch.resolve_device(device)
        B = fps.shape[0]

        def t(a):
            return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)
        mask = np.uint64(0xFFFFFFFF)
        return _ref.cuckoo_lookup_ref(
            t(fps & mask), t(fps >> np.uint64(32)), t(occ),
            t(h1a % B), t(h2a % B), t(fpa & mask), t(fpa >> np.uint64(32)))
    return cuckoo_lookup(fps, occ, h1a, h2a, fpa, device=device)


def bytes_of(x: torch.Tensor) -> torch.Tensor:
    """Bit-cast any tensor to its flat uint8 byte view (for EC over params)."""
    return gf256.bytes_view(x)


def from_bytes(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    return gf256.from_bytes_view(b, dtype, shape)
