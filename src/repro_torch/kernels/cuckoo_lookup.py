"""Batched cuckoo-index probe (the GET path's index lookup): CUDA kernel +
plain torch.

Each query probes its two candidate buckets (4 slots each) of the object
index (paper §3.2) and reports whether its fingerprint is there and the
least ``bucket*4 + slot`` holding it, else -1.

* ``cuckoo_lookup(fingerprints, occupied, h1, h2, fp)``: the JAX
  package's signature.  Kernel ``gf_cuckoo_probe`` in ``csrc/gf256.cu``
  replaces ``kernels/cuckoo_lookup.py:_probe_kernel``: one thread per
  query, native 64-bit fingerprint compares (the TPU kernel split them
  into (lo, hi) uint32 pairs for want of 64-bit lanes).

The bucket ids ``h % B`` are computed on the host in numpy, as the
reference does, and travel to the card with the fingerprints in one
copy.  Fingerprints are carried as int64 tensors: equality is bitwise, so
the results are those of uint64, and torch has few uint64 CPU ops.

Dispatch: the table's device decides (a tensor's own device; a numpy
table goes to ``device``, the card by default).  A CUDA table launches
the kernel, a CPU table takes the plain version.  Nothing falls back.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build, dispatch

#: launches of each kernel by its wrapper (plain versions do not count)
LAUNCHES = {"gf_cuckoo_probe": 0}

SLOTS = 4
#: the reference's "no hit" sentinel: slots must stay below it
_BIG = 2 ** 30


def cuckoo_probe_plain(fps: torch.Tensor, occ: torch.Tensor,
                       b1: torch.Tensor, b2: torch.Tensor,
                       fp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fps (B, 4) int64, occ (B, 4) bool, b1/b2 (Q,) bucket ids, fp (Q,)
    int64 -> (found (Q,) bool, slot (Q,) int32).  The plain version of
    the ``gf_cuckoo_probe`` kernel."""
    slot_ids = torch.arange(SLOTS, device=fps.device)[None, :]
    best = None
    for b in (b1.long(), b2.long()):
        hit = occ[b] & (fps[b] == fp[:, None])
        s = torch.where(hit, b[:, None] * SLOTS + slot_ids,
                        torch.full_like(hit, _BIG, dtype=torch.int64))
        s = s.min(dim=1).values
        best = s if best is None else torch.minimum(best, s)
    found = best < _BIG
    return found, torch.where(found, best, -1).to(torch.int32)


def _as_table(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A (B, 4) table as a contiguous tensor of ``dtype`` on its device:
    a tensor stays where it is, a numpy array goes to ``device``."""
    if isinstance(x, torch.Tensor):
        if dtype == torch.int64 and x.dtype == torch.uint64:
            x = x.view(torch.int64)
        return x.to(dtype).contiguous()
    arr = np.ascontiguousarray(x)
    if dtype == torch.int64:
        arr = arr.astype(np.uint64, copy=False).view(np.int64)
    else:
        arr = arr.astype(bool, copy=False)
    return torch.from_numpy(arr).to(dispatch.resolve_device(device))


def _host_u64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(np.asarray(x).astype(np.uint64))


def query_tensors(h1, h2, fp, num_buckets: int, device
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(b1, b2, fp) on ``device`` for (Q,) uint64 hashes and fingerprints:
    the bucket ids ``h % B`` as int32, computed on the host as the
    reference does, and the fingerprints as int64, in one copy."""
    h1, h2, fp = _host_u64(h1), _host_u64(h2), _host_u64(fp)
    Q = fp.shape[0]
    if h1.shape != (Q,) or h2.shape != (Q,):
        raise ValueError(f"h1 {h1.shape}, h2 {h2.shape}, fp {fp.shape}")
    B = np.uint64(num_buckets)
    packed = np.empty(Q * 16, dtype=np.uint8)     # fp | b1 | b2
    packed[:Q * 8] = fp.view(np.uint8)
    packed[Q * 8:Q * 12] = (h1 % B).astype(np.int32).view(np.uint8)
    packed[Q * 12:] = (h2 % B).astype(np.int32).view(np.uint8)
    buf = torch.from_numpy(packed).to(device)
    return (buf[Q * 8:Q * 12].view(torch.int32),
            buf[Q * 12:].view(torch.int32), buf[:Q * 8].view(torch.int64))


def cuckoo_lookup(fingerprints, occupied, h1, h2, fp, *, device=None):
    """Batched probe.

    fingerprints: (B, 4) uint64 (numpy, or a uint64/int64 tensor);
    occupied: (B, 4) bool; h1/h2: (Q,) uint64 hashes; fp: (Q,) uint64
    fingerprints (host arrays; tensors are read back to the host).
    Returns (found bool (Q,), slot int32 (Q,) = bucket*4+slot or -1) on
    the table's device.  ``device`` places a numpy table (default: the
    card); a tensor table runs where it lies."""
    fps = _as_table(fingerprints, torch.int64, device)
    dev = fps.device
    occ = _as_table(occupied, torch.bool, dev)
    if fps.dim() != 2 or fps.shape[1] != SLOTS:
        raise ValueError(f"fingerprints must be (B, {SLOTS}), got "
                         f"{tuple(fps.shape)}")
    B = fps.shape[0]
    if tuple(occ.shape) != (B, SLOTS) or occ.device != dev:
        raise ValueError(f"occupied {tuple(occ.shape)} on {occ.device} vs "
                         f"fingerprints {(B, SLOTS)} on {dev}")
    if B == 0:
        raise ValueError("probe of an empty table")
    if B * SLOTS > _BIG:
        raise ValueError(f"{B} buckets: slot ids would reach the int32 "
                         f"slot's 2**30 sentinel")
    b1, b2, fp_d = query_tensors(h1, h2, fp, B, dev)
    Q = fp_d.shape[0]
    if not dispatch.decide(fps).kernel:
        return cuckoo_probe_plain(fps, occ, b1, b2, fp_d)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    slot = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return found, slot
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gf_cuckoo_probe(
            fps.data_ptr(), occ.data_ptr(), b1.data_ptr(), b2.data_ptr(),
            fp_d.data_ptr(), found.data_ptr(), slot.data_ptr(), Q,
            _build.stream_ptr(dev))
    _build.check(err, "gf_cuckoo_probe")
    _build.count_launch(LAUNCHES, "gf_cuckoo_probe")
    return found, slot
