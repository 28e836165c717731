"""Unified batched coding data plane: one pluggable engine, kernels → cluster.

``CodingEngine`` is the single seam every layer of the cluster drives
coding through:

    encode_batch((B, k, C))                 -> (B, m, C) parity
    decode_batch([avail...], [wanted...])   -> [{pos: chunk}, ...]
    delta_batch((B,), (B, C))               -> (B, m, C) parity deltas
    apply_delta_batch((B, m, C), ...)       -> (B, m, C) updated parity

Backends (all byte-identical, cross-validated in
``tests/test_torch_engine.py`` against the JAX package's engines):

* ``NumpyEngine``  — wraps the ``codes.Code`` classes one item at a time;
  the reference oracle.
* ``TorchEngine``  — batched plain torch ops on an explicit device (the
  kernels' plain versions); the analogue of the JAX package's
  ``JaxEngine``.
* ``CudaEngine``   — the hand-written CUDA kernels of ``kernels/``
  through ``kernels.dispatch``; the analogue of ``PallasEngine``, for
  every code (RS and XOR with r = 1, RDP with r > 1).

The device backends share a *block-linear representation* of the code: any
systematic code here (RS, RDP, XOR, none) is GF(2^8)-linear over sub-block
rows — a chunk is ``r`` sub-blocks (r=1 for RS/XOR, r=p-1 for RDP) and
encode is one (m*r, k*r) matrix over GF(2^8), probed generically from the
numpy oracle with basis vectors.  Decode inverts k available chunk-row
groups of the systematic generator (host-side, cached per erasure
pattern); deltas are column slices of the encode matrix.

Selection: ``make_engine(name, code)``; ``name=None`` reads the
``MEMEC_TORCH_ENGINE`` env var (``numpy`` | ``torch`` | ``torch:cpu`` |
``cuda``), defaulting to ``cuda``.  Device engines run on the card unless
the caller asks for the CPU (``torch:cpu``, or ``device="cpu"``); with no
card, asking for one raises.  ``configs/memec.py`` carries the same knob
for the cluster; ``engine_specs`` expands it per shard (a comma list
cycles, e.g. ``"cuda,numpy"``).

Async submission: ``submit_encode`` / ``submit_decode`` / ``submit_delta``
(and the fused fold/apply/collapse ops) return lightweight
``EngineFuture`` handles so the cluster can issue coding work while the
same shard's netsim legs are modeled in flight (``async_engine=True`` /
``$MEMEC_ASYNC``).  The numpy backend resolves lazily (the work runs at
``result()``); the torch and cuda backends launch on the current CUDA
stream at submit time and wait only at resolution (the device-to-host
copy).  Every future carries a deterministic ``work_bytes`` figure
(GF(2^8) multiply-accumulate bytes) that ``CostModel.coding_s`` turns
into modeled time; results are byte-identical to the blocking calls by
construction.

Plan/execute decode: decode is split into a ``DecodePlan`` built at
submit time from host *metadata only* — erasure-pattern signatures, the
cached ``(k*r, k*r)`` inversions (a bounded LRU, ``inv_cache_size`` /
``$MEMEC_INV_CACHE``), per-pattern group layout, and the output scatter
map — and an execute stage that issues ONE batched device matmul per
pattern group (the inverse fused with the re-encoded parity rows).  The
``device_dispatches`` counter is the probe the tests assert this with.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from collections import OrderedDict

import numpy as np

from . import gf256
from .codes import Code, RDPCode


# ---------------------------------------------------------------------------
# Block-linear representation (shared by the device backends)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockRep:
    """A code as one GF(2^8) matrix over sub-block rows.

    ``r`` sub-blocks per chunk; ``encode``: (m*r, k*r) uint8 with
    parity_blocks = encode ∘ data_blocks, where chunk (C,) reshapes to
    (r, C//r) sub-block rows.
    """
    r: int
    encode: np.ndarray  # (m*r, k*r) uint8, read-only

    @property
    def generator(self) -> np.ndarray:
        """(n*r, k*r) systematic generator [I ; encode]."""
        kr = self.encode.shape[1]
        return np.concatenate([np.eye(kr, dtype=np.uint8), self.encode])


@functools.lru_cache(maxsize=None)
def block_rep(code: Code) -> BlockRep:
    """The code's block-linear matrix, analytic where available.

    Codes exposing ``block_matrix()`` (RDP) hand over their matrix
    directly; anything else is probed from the numpy oracle with basis
    vectors — all codes here are XOR-linear maps with GF(2^8)
    coefficients, so k*r single-byte probes at chunk width r fully
    determine the encode matrix (``tests/test_codes.py`` cross-checks
    the analytic form against the probe).
    """
    r = (code.p - 1) if isinstance(code, RDPCode) else 1
    k, m = code.k, code.m
    if hasattr(code, "block_matrix"):
        E = np.asarray(code.block_matrix(), dtype=np.uint8)
        assert E.shape == (m * r, k * r), (E.shape, m, k, r)
    else:
        E = np.zeros((m * r, k * r), dtype=np.uint8)
        for j in range(k * r):
            probe = np.zeros((k, r), dtype=np.uint8)
            probe[j // r, j % r] = 1
            E[:, j] = code.encode(probe).reshape(m * r)
    E.setflags(write=False)
    return BlockRep(r=r, encode=E)


# ---------------------------------------------------------------------------
# Decode plan (host metadata only — no chunk bytes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeGroup:
    """One erasure-pattern group of a batched decode.

    ``idxs``: batch items sharing the pattern; ``use``: the chunk
    positions feeding the inverse (sorted availability, first k);
    ``inv``: the cached (k*r, k*r) inverse; ``need_par``/``par_rows``:
    parity positions to re-encode and their generator rows.
    """
    idxs: tuple[int, ...]
    use: tuple[int, ...]
    inv: np.ndarray
    wanted: tuple[int, ...]
    need_par: tuple[int, ...]
    par_rows: np.ndarray | None


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Everything a decode needs besides the chunk bytes: the pattern
    group-by, per-group inverses, and the output scatter map.  Built
    from host metadata at submit time so device backends can dispatch
    the per-group matmuls immediately."""
    n_items: int
    chunk_size: int
    groups: tuple[DecodeGroup, ...]


# ---------------------------------------------------------------------------
# Async submission handles
# ---------------------------------------------------------------------------

class EngineFuture:
    """Handle to a submitted coding op.

    ``result()`` returns host numpy arrays, computing (numpy backend) or
    blocking on the already-launched device work (torch/cuda) on first
    call; resolution is idempotent.  ``work_bytes`` is the deterministic
    modeled-cost input for ``CostModel.coding_s`` — identical whether the
    op ran sync or async, so latency accounting can't drift between the
    two modes.
    """

    __slots__ = ("_thunk", "_value", "_done", "work_bytes", "kind")

    def __init__(self, thunk, work_bytes: int = 0, kind: str = ""):
        self._thunk = thunk
        self._value = None
        self._done = False
        self.work_bytes = work_bytes
        self.kind = kind

    @classmethod
    def wrap(cls, value, work_bytes: int = 0, kind: str = "") -> "EngineFuture":
        """An already-resolved future (empty batches, degenerate codes)."""
        fut = cls(None, work_bytes, kind)
        fut._value = value
        fut._done = True
        return fut

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            self._value = self._thunk()
            self._done = True
            self._thunk = None
        return self._value


# ---------------------------------------------------------------------------
# Engine interface
# ---------------------------------------------------------------------------

class CodingEngine:
    """Batched encode/decode/delta over a fixed ``Code``.

    All arrays are host numpy uint8 at the interface (the cluster
    simulation lives on host); device backends convert internally.
    """

    name = "base"

    #: default bound for the decode-inverse LRU (see ``inv_cache_size``)
    DEFAULT_INV_CACHE = 256

    def __init__(self, code: Code, inv_cache_size: int | None = None):
        self.code = code
        self.rep = block_rep(code)
        # decode-matrix cache: erasure patterns recur per failed server,
        # but rolling failures across many patterns must not grow it
        # without bound — bounded LRU (knob: ctor arg or $MEMEC_INV_CACHE)
        if inv_cache_size is None:
            inv_cache_size = int(os.environ.get("MEMEC_INV_CACHE",
                                                self.DEFAULT_INV_CACHE))
        self.inv_cache_size = max(1, int(inv_cache_size))
        self._inv_cache: OrderedDict[tuple[int, ...],
                                     tuple[tuple[int, ...], np.ndarray]] = \
            OrderedDict()
        # fused decode matrices: [inv ; par_rows ∘ inv] per (use, need_par)
        # — lets the execute stage issue ONE matmul per pattern group
        # instead of matmul + re-encode pass (same LRU bound as _inv_cache)
        self._fused_cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        # device-dispatch probe: device backends bump this every time a
        # kernel or device op is issued — tests assert submit_* dispatches
        # at submit (counter moves before result()), numpy stays at 0
        self.device_dispatches = 0
        # cumulative modeled engine-busy seconds (CostModel.coding_s of
        # every call merged into a request); the sharded scatter planner
        # sorts shard groups by this clock to drain idle engines first
        self.modeled_busy_s = 0.0
        # distinct (available-set, wanted) decode patterns submitted per
        # call, cumulatively — straggler races turn "which Δ dropped"
        # into per-request erasure sets, so this counter (vs inv_cache
        # occupancy) shows the pattern diversity they induce
        self.decode_patterns_submitted = 0
        # per-op dispatch provenance: every device hook records which
        # path actually ran it ("cuda-kernel" / "torch-cpu" /
        # "torch-plain", see kernels/dispatch.py) — tests and the chip
        # smoke run assert on this map
        self.op_paths: dict[str, str] = {}

    def note_modeled_busy(self, coding_s: float):
        """Charge modeled busy seconds against this engine's clock."""
        if coding_s > 0.0:
            self.modeled_busy_s += coding_s

    def _note_decode_patterns(self, available, wanted):
        """Count the distinct (sorted available keys, wanted) patterns
        of one submit_decode call into ``decode_patterns_submitted``."""
        self.decode_patterns_submitted += len(
            {(tuple(sorted(a.keys())), tuple(w))
             for a, w in zip(available, wanted)})

    # -- core batched ops (implemented by backends) ---------------------
    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, k, C) data chunks -> (B, m, C) parity chunks."""
        raise NotImplementedError

    def decode_batch(self, available, wanted, chunk_size: int) -> list[dict]:
        """Reconstruct stripe positions for a batch of stripes.

        ``available``: sequence of {position: chunk (C,)} dicts;
        ``wanted``: sequence of position lists.  Returns one
        {position: chunk} dict per stripe.  Items sharing an erasure
        pattern are decoded together (one matrix inversion + one batched
        matmul per pattern).
        """
        raise NotImplementedError

    def delta_batch(self, data_indices, xors: np.ndarray) -> np.ndarray:
        """Parity deltas for B independent chunk mutations.

        ``data_indices``: (B,) stripe data positions; ``xors``: (B, C)
        full-chunk D ⊕ D' per item.  Returns (B, m, C); apply with
        ``parity ^= delta``.
        """
        raise NotImplementedError

    def apply_delta_batch(self, parity: np.ndarray, data_indices,
                          xors: np.ndarray) -> np.ndarray:
        """(B, m, C) parity ⊕ delta_batch(data_indices, xors)."""
        parity = np.asarray(parity, dtype=np.uint8)
        if parity.shape[1] == 0 or parity.shape[0] == 0:
            return parity.copy()
        return parity ^ self.delta_batch(data_indices, xors)

    # -- introspection ---------------------------------------------------
    def describe(self) -> dict:
        """Engine identity + the kernel dispatch path actually in use —
        the answer to "did I actually compile?" (base: host numpy)."""
        return {
            "engine": self.name,
            "code": type(self.code).__name__,
            "n": self.code.n, "k": self.code.k, "r": self.rep.r,
            "backend": "host",
            "path": "numpy-host",
            "op_paths": dict(self.op_paths),
        }

    def stats(self) -> dict:
        """Run counters: device dispatches and plan-cache occupancy."""
        return {
            "path": self.describe()["path"],
            "op_paths": dict(self.op_paths),
            "device_dispatches": self.device_dispatches,
            "inv_cache": len(self._inv_cache),
            "fused_cache": len(self._fused_cache),
            "modeled_busy_s": self.modeled_busy_s,
            "decode_patterns_submitted": self.decode_patterns_submitted,
        }

    # -- modeled work (GF(2^8) multiply-accumulate bytes per batch) -----
    def encode_work_bytes(self, batch: int, chunk_size: int) -> int:
        """(m*r, k*r) matrix times (k*r, C/r) blocks, B times."""
        return batch * self.code.m * self.code.k * self.rep.r * chunk_size

    def decode_work_bytes(self, batch: int, chunk_size: int) -> int:
        """(k*r, k*r) inverse times the available blocks, B times (the
        per-pattern inversion amortizes across the batch)."""
        return batch * self.code.k * self.code.k * self.rep.r * chunk_size

    def delta_work_bytes(self, batch: int, chunk_size: int) -> int:
        """m*r parity rows from one chunk's xor, B times."""
        return batch * self.code.m * self.rep.r * chunk_size

    # -- async submission (overridden by device backends to dispatch
    # eagerly; the base implementation defers the work to result()) -----
    def submit_encode(self, data: np.ndarray) -> EngineFuture:
        data = np.asarray(data, dtype=np.uint8)
        B, _, C = data.shape
        return EngineFuture(lambda: self.encode_batch(data),
                            self.encode_work_bytes(B, C), "encode")

    def submit_decode(self, available, wanted, chunk_size: int) -> EngineFuture:
        available = [dict(a) for a in available]
        wanted = [list(w) for w in wanted]
        self._note_decode_patterns(available, wanted)
        return EngineFuture(
            lambda: self.decode_batch(available, wanted, chunk_size),
            self.decode_work_bytes(len(available), chunk_size), "decode")

    def submit_delta(self, data_indices, xors: np.ndarray) -> EngineFuture:
        xors = np.asarray(xors, dtype=np.uint8)
        B, C = xors.shape
        return EngineFuture(lambda: self.delta_batch(data_indices, xors),
                            self.delta_work_bytes(B, C), "delta")

    def submit_fold_rows(self, data_indices, xors: np.ndarray, row_indices,
                         parity_rows: np.ndarray) -> EngineFuture:
        """Fused encode + seal-fold: per item, one parity *row*.

        Item i mutates the data chunk at stripe position
        ``data_indices[i]`` by ``xors[i]`` (B, C) and folds the resulting
        delta for parity row ``row_indices[i]`` into ``parity_rows[i]``
        (B, C) — the ``Server.submit_fold_seals`` shape, where each
        parity server folds only its own row.  Returns (B, C) updated
        rows.  Base implementation is the two-call composition (full
        delta, then row pick) the fused device kernels are byte-checked
        against; work models the single row actually produced.
        """
        xors = np.asarray(xors, dtype=np.uint8)
        parity_rows = np.asarray(parity_rows, dtype=np.uint8)
        B, C = xors.shape
        wb = B * self.rep.r * C
        if B == 0 or self.code.m == 0:
            return EngineFuture.wrap(parity_rows.copy(), wb, "fold")
        rows = np.asarray(row_indices, dtype=np.int64)
        idxs = list(data_indices)

        def thunk():
            delta = self.delta_batch(idxs, xors)          # (B, m, C)
            return parity_rows ^ delta[np.arange(B), rows]
        return EngineFuture(thunk, wb, "fold")

    def submit_apply_delta(self, parity: np.ndarray, data_indices,
                           xors: np.ndarray) -> EngineFuture:
        """Fused delta + parity apply: (B, m, C) updated parity.

        The async spelling of ``apply_delta_batch`` — device backends
        fold the delta into the parity inside one kernel instead of
        materializing (B, m, C) deltas and XORing on the host.
        """
        parity = np.asarray(parity, dtype=np.uint8)
        xors = np.asarray(xors, dtype=np.uint8)
        B, C = xors.shape
        wb = self.delta_work_bytes(B, C)
        if B == 0 or parity.shape[1] == 0:
            return EngineFuture.wrap(parity.copy(), wb, "apply_delta")
        idxs = list(data_indices)
        return EngineFuture(
            lambda: self.apply_delta_batch(parity, idxs, xors),
            wb, "apply_delta")

    def collapse_work_bytes(self, versions, chunk_size: int) -> int:
        """Modeled cost of a version-collapse flush: one delta round
        plus the XOR pass over every buffered version's bytes.  Shared
        by all backends so hot-tier latency accounting can't drift."""
        return (self.delta_work_bytes(len(versions), chunk_size)
                + sum(int(np.asarray(v).size) for v in versions))

    def submit_delta_collapse(self, parity: np.ndarray, data_indices,
                              version_xors) -> EngineFuture:
        """Fold V buffered versions per item into parity in ONE round.

        ``version_xors``: per item, a (V_i, C) uint8 array of successive
        version deltas (each XOR against the then-current chunk bytes);
        their XOR-fold is the collapsed base→latest delta, so N buffered
        updates to a hot key cost one parity round instead of N.
        ``parity`` (B, m, C); returns a future of updated parity.  The
        collapse is pure XOR (associative, byte-exact), so every backend
        is byte-identical to applying the versions one at a time.
        """
        parity = np.asarray(parity, dtype=np.uint8)
        versions = [np.asarray(v, dtype=np.uint8) for v in version_xors]
        B, C = len(versions), parity.shape[2]
        wb = self.collapse_work_bytes(versions, C)
        if B == 0 or parity.shape[1] == 0:
            return EngineFuture.wrap(parity.copy(), wb, "delta_collapse")
        idxs = list(data_indices)

        def thunk():
            collapsed = np.stack(
                [np.bitwise_xor.reduce(v, axis=0) for v in versions])
            return self.apply_delta_batch(parity, idxs, collapsed)
        return EngineFuture(thunk, wb, "delta_collapse")

    # -- shared decode plumbing -----------------------------------------
    def _decode_inverse(self, avail_sig: tuple[int, ...]
                        ) -> tuple[tuple[int, ...], np.ndarray]:
        """(positions used, (k*r, k*r) inverse) for an availability set.

        Mirrors ``RSCode.decode_matrix``: sorted positions, first k.  For
        an MDS code, restricting to any k available chunks is equivalent
        to erasing the rest — within tolerance, hence invertible.
        """
        hit = self._inv_cache.get(avail_sig)
        if hit is not None:
            self._inv_cache.move_to_end(avail_sig)
            return hit
        k, r = self.code.k, self.rep.r
        if len(avail_sig) < k:
            raise ValueError(
                f"need {k} chunks, got {len(avail_sig)} — beyond erasure "
                f"tolerance of {type(self.code).__name__}"
                f"({self.code.n},{k})")
        use = avail_sig[:k]
        G = self.rep.generator
        rows = np.concatenate([G[p * r:(p + 1) * r] for p in use])
        inv = gf256.gf_mat_inv(rows)
        self._inv_cache[avail_sig] = (use, inv)
        while len(self._inv_cache) > self.inv_cache_size:
            self._inv_cache.popitem(last=False)
        return use, inv

    def plan_decode(self, avail_sigs, wanted, chunk_size: int) -> DecodePlan:
        """Build a ``DecodePlan`` from host metadata only.

        ``avail_sigs``: per item, the available stripe positions (any
        iterable — sorted here); ``wanted``: per item, the positions to
        reconstruct.  Items sharing (pattern, wanted) decode together:
        one cached inversion, one batched matmul, one scatter group.
        """
        k, r = self.code.k, self.rep.r
        G = self.rep.generator
        sigs = [tuple(sorted(s)) for s in avail_sigs]
        wsigs = [tuple(w) for w in wanted]
        by_pattern: dict[tuple, list[int]] = {}
        for i, key in enumerate(zip(sigs, wsigs)):
            by_pattern.setdefault(key, []).append(i)
        groups = []
        for (sig, wsig), idxs in by_pattern.items():
            use, inv = self._decode_inverse(sig)
            need_par = tuple(w for w in wsig if w >= k)
            par_rows = None
            if need_par:
                par_rows = np.concatenate(
                    [G[p * r:(p + 1) * r] for p in need_par])
            groups.append(DecodeGroup(tuple(idxs), use, inv, wsig,
                                      need_par, par_rows))
        return DecodePlan(len(sigs), chunk_size, tuple(groups))

    def _fused_decode_matrix(self, g: DecodeGroup) -> np.ndarray:
        """[inv ; par_rows ∘ inv] — one matrix so a group's data recovery
        AND parity re-encode are a single device matmul instead of two
        chained ones.  The composition runs on host once per (use,
        need_par) pattern and is LRU-cached like the inversions."""
        key = (g.use, g.need_par)
        hit = self._fused_cache.get(key)
        if hit is not None:
            self._fused_cache.move_to_end(key)
            return hit
        M = g.inv if g.par_rows is None else np.concatenate(
            [g.inv, gf256.gf_matmul_np(g.par_rows, g.inv)])
        self._fused_cache[key] = M
        while len(self._fused_cache) > self.inv_cache_size:
            self._fused_cache.popitem(last=False)
        return M


class NumpyEngine(CodingEngine):
    """Reference oracle: loops the host ``codes.Code`` implementation."""

    name = "numpy"

    def encode_batch(self, data):
        data = np.asarray(data, dtype=np.uint8)
        B, k, C = data.shape
        if B == 0:
            return np.zeros((0, self.code.m, C), np.uint8)
        return np.stack([self.code.encode(d) for d in data])

    def decode_batch(self, available, wanted, chunk_size):
        return [self.code.decode(dict(a), list(w), chunk_size)
                for a, w in zip(available, wanted)]

    def delta_batch(self, data_indices, xors):
        xors = np.asarray(xors, dtype=np.uint8)
        B, C = xors.shape
        if B == 0:
            return np.zeros((0, self.code.m, C), np.uint8)
        return np.stack([self.code.xor_delta(int(i), x)
                         for i, x in zip(data_indices, xors)])




# ---------------------------------------------------------------------------
# Device backends
# ---------------------------------------------------------------------------

def _torch():
    import torch
    return torch


class TorchEngine(CodingEngine):
    """Batched plain-torch backend over the block-linear representation.

    Runs the kernels' plain torch versions on an explicit ``device``
    (``None`` means the card; with no card that raises).  Work is issued
    at submit on the device's current stream; ``EngineFuture.result()``
    waits on it through the device-to-host copy.
    """

    name = "torch"

    def __init__(self, code: Code, device=None,
                 inv_cache_size: int | None = None):
        from ..kernels import dispatch
        super().__init__(code, inv_cache_size)
        self.device = dispatch.resolve_device(device)

    def _dev(self, x):
        """Host array (or tensor) -> contiguous uint8 tensor on the
        engine's device."""
        torch = _torch()
        if isinstance(x, torch.Tensor):
            return x.to(self.device).contiguous()
        return torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.uint8)).to(self.device)

    # -- device matmul hooks (CudaEngine overrides them with the kernels).
    # They return device tensors without waiting, so submit_* can issue
    # work and only synchronize at EngineFuture.result().
    def _matmul_dev(self, M: np.ndarray, blocks):
        """(O, J) ∘ (B, J, Cb) -> (B, O, Cb) over GF(2^8), device-side."""
        from ..kernels import dispatch
        from ..kernels.gf256_matmul import gf256_matmul_batched_plain
        self.device_dispatches += 1
        self.op_paths["matmul"] = dispatch.PLAIN
        return gf256_matmul_batched_plain(M, self._dev(blocks))

    def _matmul_per_item_dev(self, Ms: np.ndarray, blocks, parity=None):
        """(B, O, J) ∘ (B, J, Cb) -> (B, O, Cb), one matrix per item;
        ``parity`` (B, O, Cb), when given, is folded in."""
        from ..kernels import dispatch
        from ..kernels.gf256_matmul import gf256_matmul_per_item_plain
        self.device_dispatches += 1
        self.op_paths["delta_per_item"] = dispatch.PLAIN
        return gf256_matmul_per_item_plain(
            Ms, self._dev(blocks),
            None if parity is None else self._dev(parity))

    def describe(self) -> dict:
        from ..kernels import dispatch
        d = super().describe()
        d.update(backend=self.device.type, path=dispatch.PLAIN,
                 device=str(self.device))
        return d

    @staticmethod
    def _resolve_dev(dev, shape):
        """Blocking resolution of a launched device tensor (the only
        place the async path waits on the device: the copy to host)."""
        return dev.cpu().numpy().reshape(shape)

    def submit_encode(self, data):
        data = np.asarray(data, dtype=np.uint8)
        B, k, C = data.shape
        m = self.code.m
        wb = self.encode_work_bytes(B, C)
        if B == 0 or m == 0:
            return EngineFuture.wrap(np.zeros((B, m, C), np.uint8), wb,
                                     "encode")
        dev = self._matmul_dev(self.rep.encode, self._blocks(data))
        return EngineFuture(lambda: self._resolve_dev(dev, (B, m, C)),
                            wb, "encode")

    def submit_delta(self, data_indices, xors):
        xors = np.asarray(xors, dtype=np.uint8)
        B, C = xors.shape
        m, k, r = self.code.m, self.code.k, self.rep.r
        wb = self.delta_work_bytes(B, C)
        if B == 0 or m == 0:
            return EngineFuture.wrap(np.zeros((B, m, C), np.uint8), wb,
                                     "delta")
        idx = np.asarray(data_indices, dtype=np.int64)
        cols = self.rep.encode.reshape(m * r, k, r)[:, idx, :]
        Ms = np.ascontiguousarray(np.transpose(cols, (1, 0, 2)))
        dev = self._matmul_per_item_dev(Ms, xors.reshape(B, r, C // r))
        return EngineFuture(lambda: self._resolve_dev(dev, (B, m, C)),
                            wb, "delta")

    def submit_fold_rows(self, data_indices, xors, row_indices, parity_rows):
        """Fused: per item, the (r, r) sub-system for ONE parity row is
        multiplied against the xor blocks and folded into the row inside
        a single device call — m× less delta work than ``submit_delta``
        and no host-side XOR pass."""
        xors = np.asarray(xors, dtype=np.uint8)
        parity_rows = np.asarray(parity_rows, dtype=np.uint8)
        B, C = xors.shape
        m, k, r = self.code.m, self.code.k, self.rep.r
        wb = B * r * C
        if B == 0 or m == 0:
            return EngineFuture.wrap(parity_rows.copy(), wb, "fold")
        idx = np.asarray(data_indices, dtype=np.int64)
        rows = np.asarray(row_indices, dtype=np.int64)
        # E reshaped (m, r, k, r): item i's system is E4[row_i, :, pos_i, :]
        E4 = self.rep.encode.reshape(m, r, k, r)
        Ms = np.ascontiguousarray(E4[rows, :, idx, :])    # (B, r, r)
        dev = self._matmul_per_item_dev(Ms, xors.reshape(B, r, C // r),
                                        parity_rows.reshape(B, r, C // r))
        return EngineFuture(lambda: self._resolve_dev(dev, (B, C)),
                            wb, "fold")

    def submit_apply_delta(self, parity, data_indices, xors):
        """Fused delta + parity apply in one per-item device call."""
        parity = np.asarray(parity, dtype=np.uint8)
        xors = np.asarray(xors, dtype=np.uint8)
        B, C = xors.shape
        m, k, r = self.code.m, self.code.k, self.rep.r
        wb = self.delta_work_bytes(B, C)
        if B == 0 or m == 0:
            return EngineFuture.wrap(parity.copy(), wb, "apply_delta")
        idx = np.asarray(data_indices, dtype=np.int64)
        cols = self.rep.encode.reshape(m * r, k, r)[:, idx, :]
        Ms = np.ascontiguousarray(np.transpose(cols, (1, 0, 2)))
        dev = self._matmul_per_item_dev(Ms, xors.reshape(B, r, C // r),
                                        parity.reshape(B, m * r, C // r))
        return EngineFuture(lambda: self._resolve_dev(dev, (B, m, C)),
                            wb, "apply_delta")

    def apply_delta_batch(self, parity, data_indices, xors):
        return self.submit_apply_delta(parity, data_indices, xors).result()

    def _xor_collapse_dev(self, stacked: np.ndarray):
        """(B, V, C) -> (B, C) XOR-fold over the version axis on the
        device; torch has no XOR reduction, so it is a loop over V."""
        dev = self._dev(stacked)
        out = dev[:, 0].clone()
        for v in range(1, dev.shape[1]):
            out ^= dev[:, v]
        return out

    def submit_delta_collapse(self, parity, data_indices, version_xors):
        """Device-side collapse: pad-stack the versions (B, Vmax, C)
        (zeros are XOR-identity), XOR-fold on the device, and feed the
        fused per-item delta+apply — issued at submit like the other
        device ops.  Byte-identical to the host collapse by XOR
        associativity."""
        parity = np.asarray(parity, dtype=np.uint8)
        versions = [np.asarray(v, dtype=np.uint8) for v in version_xors]
        B, C = len(versions), parity.shape[2]
        m, k, r = self.code.m, self.code.k, self.rep.r
        wb = self.collapse_work_bytes(versions, C)
        vmax = max((v.shape[0] for v in versions), default=0)
        if B == 0 or m == 0 or vmax == 0:
            # no version at all: the XOR of none is zero, parity unchanged
            return EngineFuture.wrap(parity.copy(), wb, "delta_collapse")
        stacked = np.zeros((B, vmax, C), dtype=np.uint8)
        for i, v in enumerate(versions):
            stacked[i, :v.shape[0]] = v
        self.device_dispatches += 1
        collapsed = self._xor_collapse_dev(stacked)               # (B, C)
        idx = np.asarray(data_indices, dtype=np.int64)
        cols = self.rep.encode.reshape(m * r, k, r)[:, idx, :]
        Ms = np.ascontiguousarray(np.transpose(cols, (1, 0, 2)))
        dev = self._matmul_per_item_dev(
            Ms, collapsed.reshape(B, r, C // r),
            parity.reshape(B, m * r, C // r))
        return EngineFuture(lambda: self._resolve_dev(dev, (B, m, C)),
                            wb, "delta_collapse")

    def _blocks(self, chunks: np.ndarray) -> np.ndarray:
        """(B, x, C) -> (B, x*r, C//r) sub-block rows."""
        B, x, C = chunks.shape
        r = self.rep.r
        if C % r:
            raise ValueError(f"chunk size {C} not divisible by r={r}")
        return chunks.reshape(B, x * r, C // r)

    def encode_batch(self, data):
        # the blocking call IS the submitted future resolved on the spot
        # — one dispatch body for both paths keeps sync/async
        # byte-identity true by construction
        return self.submit_encode(data).result()

    def submit_decode(self, available, wanted, chunk_size):
        """Plan on host metadata, launch the per-group matmuls NOW.

        The plan's group-by and cached inversions need no chunk bytes,
        so the device work is issued at submit — like encode/delta —
        and ``result()`` only waits on it and scatters the output."""
        available = [dict(a) for a in available]
        wb = self.decode_work_bytes(len(available), chunk_size)
        if not available:
            return EngineFuture.wrap([], wb, "decode")
        self._note_decode_patterns(available, wanted)
        plan = self.plan_decode([a.keys() for a in available], wanted,
                                chunk_size)
        devs = self._execute_decode_dev(plan, available)
        return EngineFuture(lambda: self._scatter_decode(plan, devs),
                            wb, "decode")

    def _execute_decode_dev(self, plan: DecodePlan, available) -> list:
        """Execute stage: ONE batched device matmul per pattern group.

        The group's inverse and its re-encoded-parity rows are fused into
        a single host-composed matrix (``_fused_decode_matrix``), so the
        matmul -> parity-re-encode chain is one kernel."""
        devs = []
        for g in plan.groups:
            stacked = np.stack(
                [np.stack([np.asarray(available[i][p], np.uint8)
                           for p in g.use]) for i in g.idxs])  # (Bg, k, C)
            M = self._fused_decode_matrix(g)
            devs.append(self._matmul_dev(M, self._blocks(stacked)))
        return devs

    def _scatter_decode(self, plan: DecodePlan, devs) -> list[dict]:
        """Resolution: wait on the launched groups and scatter each
        item's wanted positions back into per-stripe dicts.  The fused
        matmul output is (Bg, k + n_par, C): data rows then the
        re-encoded parity rows."""
        k, C = self.code.k, plan.chunk_size
        results: list[dict | None] = [None] * plan.n_items
        for g, dev in zip(plan.groups, devs):
            Bg, npar = len(g.idxs), len(g.need_par)
            out = self._resolve_dev(dev, (Bg, k + npar, C))
            for bi, i in enumerate(g.idxs):
                results[i] = {w: (out[bi, w] if w < k
                                  else out[bi, k + g.need_par.index(w)])
                              for w in g.wanted}
        return results

    def decode_batch(self, available, wanted, chunk_size):
        # same plan/execute body as the submitted path, resolved on the
        # spot — sync/async byte-identity true by construction
        return self.submit_decode(available, wanted, chunk_size).result()

    def delta_batch(self, data_indices, xors):
        return self.submit_delta(data_indices, xors).result()


class CudaEngine(TorchEngine):
    """The hand-written CUDA kernels, for every code.

    Encode and the fused decode run ``gf256_matmul_batched``, whose
    strategy rule sends RS/XOR matrices to the unroll kernel, RDP's 0/1
    block matrices to the 0/1 kernel and large dense matrices to the
    column-loop kernel.  The seal fold rows and the hot-key collapse run
    the per-item fold.  For r = 1 codes sealed updates run
    ``delta_apply_batched`` (with parity) and degraded mutates its
    delta-only body; for r > 1 (RDP) both take the inherited per-item
    path (the per-item fold and the plain per-item kernel), as the JAX
    package's ``PallasEngine`` does.  Which path each op took comes from
    ``kernels.dispatch`` and lands in ``op_paths``: ``cuda-kernel`` on
    the card, ``torch-cpu`` when the caller asked for ``device="cpu"``.
    """

    name = "cuda"

    def _matmul_dev(self, M, blocks):
        from ..kernels import dispatch
        from ..kernels.gf256_matmul import gf256_matmul_batched
        blocks = self._dev(blocks)
        self.device_dispatches += 1
        self.op_paths["matmul"] = dispatch.decide(blocks).path
        return gf256_matmul_batched(M, blocks)

    def _matmul_per_item_dev(self, Ms, blocks, parity=None):
        from ..kernels import dispatch
        from ..kernels.delta_update import delta_apply_per_item_batched
        blocks = self._dev(blocks)
        self.device_dispatches += 1
        self.op_paths["delta_per_item"] = dispatch.decide(blocks).path
        return delta_apply_per_item_batched(
            None if parity is None else self._dev(parity), Ms, blocks)

    def describe(self) -> dict:
        from ..kernels import dispatch
        d = CodingEngine.describe(self)
        d.update(dispatch.describe(self.device), device=str(self.device))
        return d

    def _gammas(self, data_indices) -> np.ndarray:
        idx = np.asarray(data_indices, dtype=np.int64)
        return np.ascontiguousarray(self.rep.encode[:, idx].T)   # (B, m)

    def _delta_dev(self, parity, data_indices, xors):
        """Launch the batched delta kernel: with parity, the fused
        delta + apply; without, the bare deltas."""
        from ..kernels import dispatch
        from ..kernels.delta_update import delta_apply_batched
        x = self._dev(xors)
        self.device_dispatches += 1
        self.op_paths["delta"] = dispatch.decide(x).path
        return delta_apply_batched(
            None if parity is None else self._dev(parity),
            self._gammas(data_indices), x)

    def submit_delta(self, data_indices, xors):
        if self.rep.r != 1:
            # r > 1: one (m*r, r) matrix per item, the plain per-item kernel
            return super().submit_delta(data_indices, xors)
        xors = np.asarray(xors, dtype=np.uint8)
        B, C = xors.shape
        wb = self.delta_work_bytes(B, C)
        if B == 0 or self.code.m == 0:
            return EngineFuture.wrap(np.zeros((B, self.code.m, C), np.uint8),
                                     wb, "delta")
        dev = self._delta_dev(None, data_indices, xors)
        return EngineFuture(
            lambda: self._resolve_dev(dev, (B, self.code.m, C)), wb, "delta")

    def submit_apply_delta(self, parity, data_indices, xors):
        if self.rep.r != 1:
            # r > 1: the per-item fold kernel, parity folded in
            return super().submit_apply_delta(parity, data_indices, xors)
        parity = np.asarray(parity, dtype=np.uint8)
        xors = np.asarray(xors, dtype=np.uint8)
        B, C = xors.shape
        wb = self.delta_work_bytes(B, C)
        if B == 0 or parity.shape[1] == 0:
            return EngineFuture.wrap(parity.copy(), wb, "apply_delta")
        dev = self._delta_dev(parity, data_indices, xors)
        return EngineFuture(
            lambda: self._resolve_dev(dev, parity.shape), wb, "apply_delta")


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------

ENGINES = {
    "numpy": NumpyEngine,
    "torch": TorchEngine,
    "cuda": CudaEngine,
}


def make_engine(name: str | None, code: Code) -> CodingEngine:
    """Build a backend for ``code``.

    ``name=None`` falls back to ``$MEMEC_TORCH_ENGINE`` then ``"cuda"``.
    Device engines take an optional device after a colon
    (``torch:cpu``); without one they run on the card and raise when
    there is none.  A comma-separated list (the per-shard spelling)
    collapses to its first entry when a single engine is requested.
    """
    if isinstance(name, CodingEngine):
        return name
    name = (name or os.environ.get("MEMEC_TORCH_ENGINE") or "cuda").lower()
    if "," in name:
        name = name.split(",")[0].strip()
    base, _, device = name.partition(":")
    try:
        cls = ENGINES[base]
    except KeyError:
        raise ValueError(
            f"unknown coding engine {name!r}; pick from "
            f"{sorted(ENGINES)} (device engines also as 'torch:cpu')")
    if cls is NumpyEngine:
        if device:
            raise ValueError(f"the numpy engine takes no device: {name!r}")
        return cls(code)
    return cls(code, device=device or None)


def resolve_async(async_engine=None) -> bool:
    """Async-pipeline knob: the argument, else ``$MEMEC_ASYNC`` (truthy
    spellings: 1/true/yes/on), defaulting to the synchronous pipeline."""
    if async_engine is None:
        return os.environ.get("MEMEC_ASYNC", "").strip().lower() in (
            "1", "true", "yes", "on")
    return bool(async_engine)


def engine_specs(spec, num_shards: int) -> list:
    """Expand an engine spec into one entry per shard.

    ``spec`` may be None (defer to ``$MEMEC_TORCH_ENGINE``, itself
    possibly a comma list), a single backend name, a comma-separated
    string, a list/tuple of names, or a ``CodingEngine`` instance;
    shorter lists cycle (e.g. ``"cuda,numpy"`` over 4 shards ->
    cuda/numpy/cuda/numpy — kernels for hot shards, numpy elsewhere).
    Names keep their device suffix (``"cuda:cpu,numpy"``); ``make_engine``
    splits it."""
    if spec is None:
        spec = os.environ.get("MEMEC_TORCH_ENGINE")
    if isinstance(spec, str) and "," in spec:
        spec = [s.strip() for s in spec.split(",") if s.strip()]
    if isinstance(spec, (list, tuple)):
        if not spec:
            raise ValueError("empty engine spec list")
        return [spec[i % len(spec)] for i in range(num_shards)]
    return [spec] * num_shards
