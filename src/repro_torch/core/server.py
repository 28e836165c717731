"""MemEC storage server (paper §4): memory region, indexes, sealing, parity.

A server plays a *data* role for some stripe lists and a *parity* role for
others (roles are per-list, §2).  The server owns:

* a memory region of fixed-size chunks (list of 4 KB numpy buffers),
* the local-only object index (key -> ObjectRef) and chunk index
  (chunk-ID -> local chunk slot) — cuckoo hash tables (§3.2),
* per-list unsealed data chunks (fixed count; min-free-fit policy §4.2),
* per-list stripe-ID counters,
* the parity-role temporary replica buffer (objects of unsealed remote
  chunks) and parity chunks proper,
* a delta buffer for revert-on-failure (§5.3), and
* the key->chunk-ID mapping log with periodic checkpoints (§5.3).

Implementation note: the paper assigns the stripe ID at *seal* time; we
assign it at chunk-*open* time (same uniqueness/monotonicity) so that the
key->chunk-ID mapping can be piggybacked on the SET acknowledgement, which
§5.3 requires.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from .chunk import (CHUNK_SIZE, ChunkBuilder, ChunkId, ObjectRef,
                    object_size, pack_object, parse_objects)
from .codes import Code
from .engine import CodingEngine, NumpyEngine
from .index import CuckooIndex
from .stripe import StripeList


@dataclasses.dataclass
class UnsealedChunk:
    builder: ChunkBuilder
    local_idx: int
    chunk_id: ChunkId


@dataclasses.dataclass
class SealEvent:
    """Emitted when a data chunk seals; the network carries keys only.

    ``iseqs`` (aligned with ``ordered_keys``) are the per-instance
    sequence numbers the data server assigned at SET time: a key that was
    deleted and re-SET has several instances in flight (the tombstoned
    slot in the old unsealed chunk plus the live one), and the parity
    rebuild must consume each chunk's *own* instance replica regardless
    of the order the chunks seal in."""
    stripe_list: StripeList
    chunk_id: ChunkId
    ordered_keys: list[bytes]
    payload_bytes: int  # what actually crosses the network
    iseqs: list[int] | None = None


@dataclasses.dataclass
class DeltaRecord:
    """Parity-side backup of an applied delta, for revert (§5.3)."""
    proxy_id: int
    seq: int
    local_idx: int          # parity chunk slot (-1 => replica update)
    offset: int
    applied: np.ndarray     # exact bytes XORed into the parity chunk
    key: bytes | None = None
    old_value: bytes | None = None  # for unsealed-replica updates
    old_deleted: bool = False


class Server:
    def __init__(self, sid: int, code: Code, chunk_size: int = CHUNK_SIZE,
                 max_unsealed_per_list: int = 4, mapping_ckpt_every: int = 256,
                 engine: CodingEngine | None = None):
        self.sid = sid
        self.code = code
        # all parity math goes through the batched coding engine (the
        # cluster passes its shared backend; standalone servers get the
        # numpy oracle)
        self.engine = engine if engine is not None else NumpyEngine(code)
        self.chunk_size = chunk_size
        self.max_unsealed = max_unsealed_per_list
        self.mapping_ckpt_every = mapping_ckpt_every

        self.region: list[np.ndarray] = []           # local chunk slots
        self.chunk_ids: list[ChunkId | None] = []    # slot -> id
        self.sealed: list[bool] = []                 # slot -> sealed?
        self.chunk_index = CuckooIndex(num_buckets=1 << 10)
        self.object_index = CuckooIndex(num_buckets=1 << 12)

        self.unsealed: dict[int, list[UnsealedChunk]] = defaultdict(list)
        self.stripe_counters: dict[int, int] = defaultdict(int)

        # parity role: `temp_replicas` holds the LIVE instance per key
        # (what degraded reads and replica deltas see); a superseded
        # instance whose unsealed chunk has not sealed yet parks in
        # `zombie_replicas` under (key, instance seq) until its seal
        # consumes it — chunks seal in arbitrary (min-free-victim) order,
        # so instance identity, not recency, picks the rebuild bytes.
        self.temp_replicas: dict[bytes, tuple[bytes, bool]] = {}  # key -> (value, deleted)
        self.replica_iseq: dict[bytes, int] = {}     # key -> live instance seq
        self.zombie_replicas: dict[tuple[bytes, int | None],
                                   tuple[bytes, bool]] = {}
        self.delta_buffer: dict[int, list[DeltaRecord]] = defaultdict(list)

        # key -> chunk-ID mapping log (checkpointed to coordinator §5.3);
        # entries carry the instance seq so the coordinator's recovery
        # merge keeps the *newest* instance when a key was re-SET into a
        # different chunk (delete/re-add churn, shard migration)
        self.mapping_log: list[tuple[bytes, ChunkId, int]] = []
        self.mappings_since_ckpt = 0

        # data role: per-SET instance sequence numbers, (chunk slot,
        # offset) -> iseq, piggybacked on seal events so parity replica
        # consumption matches instances (see SealEvent.iseqs)
        self.obj_seq = 0
        self._iseq: dict[tuple[int, int], int] = {}

        # stats
        self.seals = 0
        self.bytes_stored = 0

    # ------------------------------------------------------------------
    # region management
    # ------------------------------------------------------------------
    def _alloc_slot(self, chunk_id: ChunkId | None, buf: np.ndarray | None = None) -> int:
        idx = len(self.region)
        self.region.append(buf if buf is not None else np.zeros(self.chunk_size, np.uint8))
        self.chunk_ids.append(chunk_id)
        self.sealed.append(False)
        if chunk_id is not None:
            self.chunk_index.insert(chunk_id.pack(), idx)
        return idx

    def slot_of_chunk(self, chunk_id: ChunkId) -> int | None:
        return self.chunk_index.lookup(chunk_id.pack())

    def get_sealed_chunk(self, chunk_id: ChunkId) -> np.ndarray | None:
        """Sealed chunk content, or None (unsealed/unknown chunks encode as
        zero in parity, so callers substitute zeros)."""
        idx = self.slot_of_chunk(chunk_id)
        if idx is None or not self.sealed[idx]:
            return None
        return self.region[idx]

    # ------------------------------------------------------------------
    # data role: SET / GET / UPDATE / DELETE
    # ------------------------------------------------------------------
    def _open_chunk(self, sl: StripeList) -> UnsealedChunk:
        position = sl.data_servers.index(self.sid)
        sid_ctr = self.stripe_counters[sl.list_id]
        self.stripe_counters[sl.list_id] = sid_ctr + 1
        cid = ChunkId(sl.list_id, sid_ctr, position)
        builder = ChunkBuilder(self.chunk_size)
        idx = self._alloc_slot(cid, builder.buf)
        uc = UnsealedChunk(builder, idx, cid)
        self.unsealed[sl.list_id].append(uc)
        return uc

    def _seal(self, sl: StripeList, uc: UnsealedChunk) -> SealEvent:
        self.unsealed[sl.list_id].remove(uc)
        uc.builder.seal()
        self.sealed[uc.local_idx] = True
        self.seals += 1
        keys = [k for k, _ in uc.builder.objects]
        iseqs = [self._iseq.pop((uc.local_idx, off), None)
                 for _, off in uc.builder.objects]
        payload = sum(len(k) + 1 for k in keys)  # keys (+1B length) only
        return SealEvent(sl, uc.chunk_id, keys, payload, iseqs=iseqs)

    def set_object(self, sl: StripeList, key: bytes, value: bytes
                   ) -> tuple[ChunkId, int, list[SealEvent]]:
        """Append a new object; returns (chunk_id, offset, seal events)."""
        need = object_size(len(key), len(value))
        if need > self.chunk_size:
            raise ValueError("object exceeds chunk size; fragment first")
        events: list[SealEvent] = []
        chunks = self.unsealed[sl.list_id]
        # min-free-fit: the unsealed chunk with the least free space that fits
        fitting = [c for c in chunks if c.builder.free >= need]
        if fitting:
            target = min(fitting, key=lambda c: c.builder.free)
        else:
            if len(chunks) >= self.max_unsealed and chunks:
                # seal the chunk with the least free space to make room
                victim = min(chunks, key=lambda c: c.builder.free)
                events.append(self._seal(sl, victim))
            target = self._open_chunk(sl)
        off = target.builder.append(key, value)
        ref = ObjectRef(target.local_idx, off, len(key), len(value))
        self.object_index.insert(key, ref)
        self._iseq[(target.local_idx, off)] = self.obj_seq
        self.obj_seq += 1
        self.mapping_log.append((key, target.chunk_id, self._iseq[(target.local_idx, off)]))
        self.mappings_since_ckpt += 1
        self.bytes_stored += need
        return target.chunk_id, off, events

    def live_iseq(self, key: bytes) -> int | None:
        """Instance sequence of the key's live (unsealed) slot, if any —
        what callers pass to the parity servers' ``store_replica``."""
        ref = self.lookup(key)
        if ref is None:
            return None
        return self._iseq.get((ref.chunk_local_idx, ref.offset))

    def lookup(self, key: bytes) -> ObjectRef | None:
        return self.object_index.lookup(key)

    def get_value(self, key: bytes) -> bytes | None:
        ref = self.lookup(key)
        if ref is None:
            return None
        buf = self.region[ref.chunk_local_idx]
        vo = ref.value_offset
        return buf[vo: vo + ref.value_size].tobytes()

    def chunk_id_of(self, ref: ObjectRef) -> ChunkId:
        cid = self.chunk_ids[ref.chunk_local_idx]
        assert cid is not None
        return cid

    def update_value(self, key: bytes, new_value: bytes
                     ) -> tuple[ChunkId, bool, int, np.ndarray] | None:
        """In-place value update.  Returns (chunk_id, chunk_sealed,
        object_offset, xor_over_object_extent) or None if key unknown.
        Value sizes are fixed across updates (paper §4.2).
        """
        ref = self.lookup(key)
        if ref is None:
            return None
        if len(new_value) != ref.value_size:
            raise ValueError("value size must not change across updates")
        buf = self.region[ref.chunk_local_idx]
        ext = object_size(ref.key_size, ref.value_size)
        old = buf[ref.offset: ref.offset + ext].copy()
        vo = ref.value_offset
        buf[vo: vo + ref.value_size] = np.frombuffer(new_value, np.uint8)
        xor = old ^ buf[ref.offset: ref.offset + ext]
        return self.chunk_id_of(ref), self.sealed[ref.chunk_local_idx], ref.offset, xor

    def delete_object(self, key: bytes
                      ) -> tuple[ChunkId, bool, int, np.ndarray] | None:
        """Tombstone + zero the value.  Returns like update_value."""
        ref = self.lookup(key)
        if ref is None:
            return None
        buf = self.region[ref.chunk_local_idx]
        ext = object_size(ref.key_size, ref.value_size)
        old = buf[ref.offset: ref.offset + ext].copy()
        self._builder_view(ref).mark_deleted(ref.offset, ref.key_size, ref.value_size)
        xor = old ^ buf[ref.offset: ref.offset + ext]
        self.object_index.delete(key)
        return self.chunk_id_of(ref), self.sealed[ref.chunk_local_idx], ref.offset, xor

    def _builder_view(self, ref: ObjectRef):
        """A ChunkBuilder-shaped view over a slot for in-place ops."""
        v = ChunkBuilder.__new__(ChunkBuilder)
        v.chunk_size = self.chunk_size
        v.buf = self.region[ref.chunk_local_idx]
        v.used = self.chunk_size
        v.objects = []
        v.sealed = False
        return v

    # ------------------------------------------------------------------
    # parity role
    # ------------------------------------------------------------------
    def store_replica(self, key: bytes, value: bytes,
                      iseq: int | None = None):
        """Store the live replica of an unsealed object.  When a prior
        instance of the key is still awaiting its chunk's seal (delete →
        re-SET while the old chunk never sealed), it parks as a zombie
        under its own instance seq so the old chunk's rebuild consumes
        the frozen tombstone, not the new value."""
        old = self.temp_replicas.get(key)
        old_iseq = self.replica_iseq.get(key)
        if old is not None and old_iseq != iseq:
            # a superseded instance is always a tombstone (set_object
            # only re-adds a key after delete), so park its final state
            # even if this copy missed the delete delta (failed parity)
            self.zombie_replicas[(key, old_iseq)] = \
                (b"\x00" * len(old[0]), True)
        self.temp_replicas[key] = (value, False)
        if iseq is None:
            self.replica_iseq.pop(key, None)
        else:
            self.replica_iseq[key] = iseq

    def get_replica(self, key: bytes):
        return self.temp_replicas.get(key)

    def _consume_replica(self, key: bytes, iseq: int | None
                         ) -> tuple[tuple[bytes, bool], bool]:
        """Replica bytes for instance ``iseq`` of ``key`` at seal time:
        a parked zombie instance wins; otherwise the live entry must
        match (or carry no instance id — legacy/shadow-migrated state).
        Returns (replica, consumed_live)."""
        if iseq is not None:
            z = self.zombie_replicas.pop((key, iseq), None)
            if z is not None:
                return z, False
        rep = self.temp_replicas.get(key)
        live = self.replica_iseq.get(key)
        if rep is not None and (iseq is None or live is None or live == iseq):
            return rep, True
        z = self.zombie_replicas.pop((key, None), None)
        if z is not None:
            return z, False
        raise KeyError(f"parity {self.sid}: missing replica for {key!r} "
                       f"(instance {iseq}, live {live})")

    def _parity_slot_for(self, sl: StripeList, stripe_id: int) -> int:
        ppos = sl.parity_servers.index(self.sid)
        cid = ChunkId(sl.list_id, stripe_id, sl.k + ppos)
        idx = self.slot_of_chunk(cid)
        if idx is None:
            idx = self._alloc_slot(cid)
            self.sealed[idx] = True  # parity chunks are never appended to
        return idx

    def parity_row(self, sl: StripeList, stripe_id: int) -> np.ndarray:
        """Parity role: this server's parity chunk for a stripe
        (allocated zero on first touch — identical bytes to the
        unallocated case).  The cluster's fused delta+apply path gathers
        these as the kernel's parity input."""
        return self.region[self._parity_slot_for(sl, stripe_id)]

    def rebuild_seal_chunk(self, ev: SealEvent) -> tuple[int, int, np.ndarray]:
        """Parity role, step 1 of a seal: rebuild the sealed data chunk from
        replicas, allocate the parity slot, and drop the consumed replicas.
        Returns (parity slot, data position, rebuilt chunk); the parity fold
        itself is batched across seal events by the caller (paper §4.2).

        Replicas are matched by instance (see ``SealEvent.iseqs``): the
        seal of an old chunk holding a superseded tombstone consumes that
        instance's parked zombie replica and leaves the live replica of
        the key's re-SET instance — still unsealed elsewhere — intact."""
        iseqs = ev.iseqs or [None] * len(ev.ordered_keys)
        rebuilt = np.zeros(self.chunk_size, np.uint8)
        off = 0
        consumed_live: list[bytes] = []
        for key, iseq in zip(ev.ordered_keys, iseqs):
            (value, deleted), was_live = self._consume_replica(key, iseq)
            blob = pack_object(key, value if not deleted else b"\x00" * len(value),
                               deleted=deleted)
            rebuilt[off: off + len(blob)] = np.frombuffer(blob, np.uint8)
            off += len(blob)
            if was_live:
                consumed_live.append(key)
        idx = self._parity_slot_for(ev.stripe_list, ev.chunk_id.stripe_id)
        for key in consumed_live:
            self.temp_replicas.pop(key, None)
            self.replica_iseq.pop(key, None)
        return idx, ev.chunk_id.position, rebuilt

    def apply_seal(self, ev: SealEvent) -> np.ndarray:
        """Parity role: rebuild + fold one sealed chunk (B=1 case of
        `fold_seal_batch`)."""
        return self.fold_seal_batch([ev])[0]

    def fold_seal_batch(self, events: list[SealEvent]) -> list[np.ndarray]:
        """Parity role: rebuild all sealed chunks, then fold their parity
        contributions in one batched engine call."""
        fut, finish = self.submit_fold_seals(events)
        if fut is not None:
            fut.result()
        return finish()

    def submit_fold_seals(self, events: list[SealEvent]):
        """Async seal fold: rebuild the sealed chunks from replicas (host
        work), *submit* the batched parity-delta computation, and return
        ``(future, finish)`` — the caller models its netsim legs while the
        engine call is in flight, then calls ``finish()`` to fold the
        deltas into the parity region and get the rebuilt chunks back.
        Byte-identical to ``fold_seal_batch`` (same engine call, same fold
        order), only the synchronization point moves."""
        if not events:
            return None, lambda: []
        rebuilds = [self.rebuild_seal_chunk(ev) for ev in events]
        positions = np.array([pos for _, pos, _ in rebuilds])
        xors = np.stack([reb for _, _, reb in rebuilds])
        # fused encode + seal-fold: this server only ever folds its OWN
        # parity row per event, so submit the row-fold (r*C work/item)
        # instead of the full m-row delta the old path discarded m-1 of
        rows = np.array([ev.stripe_list.parity_servers.index(self.sid)
                         for ev in events])
        slots = [idx for idx, _, _ in rebuilds]
        old_rows = np.stack([self.region[idx] for idx in slots])
        fut = self.engine.submit_fold_rows(positions, xors, rows, old_rows)

        def finish() -> list[np.ndarray]:
            new_rows = fut.result()                       # (B, C)
            counts: dict[int, int] = {}
            for idx in slots:
                counts[idx] = counts.get(idx, 0) + 1
            for i, idx in enumerate(slots):
                if counts[idx] == 1:
                    self.region[idx][:] = new_rows[i]
                else:
                    # two chunks of one stripe sealing in the same batch
                    # share a parity slot; both folds gathered the same
                    # pre-batch row, so apply each event's exact delta
                    # (new ^ old) instead of letting the writes clobber
                    self.region[idx] ^= new_rows[i] ^ old_rows[i]
            return [reb for _, _, reb in rebuilds]

        return fut, finish

    def apply_data_delta(self, sl: StripeList, chunk_id: ChunkId, offset: int,
                         xor_seg: np.ndarray, proxy_id: int, seq: int):
        """Parity role: apply a (sealed-chunk) update delta; buffer for
        revert (§5.3).  Runs the fused single-row fold (this server's
        parity row only) rather than materializing all m delta rows."""
        full = np.zeros(self.chunk_size, np.uint8)
        full[offset: offset + len(xor_seg)] = xor_seg
        ppos = sl.parity_servers.index(self.sid)
        idx = self._parity_slot_for(sl, chunk_id.stripe_id)
        folded = self.engine.submit_fold_rows(
            np.array([chunk_id.position]), full[None], np.array([ppos]),
            self.region[idx][None]).result()[0]
        self.apply_data_delta_row(sl, chunk_id, folded ^ self.region[idx],
                                  proxy_id, seq)

    def apply_data_delta_row(self, sl: StripeList, chunk_id: ChunkId,
                             delta_row: np.ndarray, proxy_id: int, seq: int):
        """Parity role: fold a precomputed delta row for this server's
        parity position (the multi-key path computes rows for all parity
        servers in one batched engine call)."""
        idx = self._parity_slot_for(sl, chunk_id.stripe_id)
        self.region[idx] ^= delta_row
        self.delta_buffer[proxy_id].append(DeltaRecord(
            proxy_id=proxy_id, seq=seq, local_idx=idx, offset=0,
            applied=np.array(delta_row, np.uint8)))

    def apply_replica_delta(self, key: bytes, new_value: bytes, deleted: bool,
                            proxy_id: int, seq: int):
        """Parity role: update an unsealed object's replica; buffer old."""
        rep = self.temp_replicas.get(key)
        if rep is None:
            raise KeyError(f"parity {self.sid}: no replica for {key!r}")
        old_value, old_deleted = rep
        if deleted and not new_value:
            new_value = b"\x00" * len(old_value)  # keep size for rebuild
        self.temp_replicas[key] = (new_value, deleted)
        self.delta_buffer[proxy_id].append(DeltaRecord(
            proxy_id=proxy_id, seq=seq, local_idx=-1, offset=0,
            applied=np.zeros(0, np.uint8), key=key,
            old_value=old_value, old_deleted=old_deleted))

    def revert_deltas(self, proxy_id: int, unacked_seqs: set[int]) -> int:
        """Revert buffered deltas of a proxy's unacknowledged requests."""
        reverted = 0
        keep = []
        for rec in self.delta_buffer.get(proxy_id, []):
            if rec.seq in unacked_seqs:
                if rec.local_idx >= 0:
                    self.region[rec.local_idx] ^= rec.applied
                else:
                    self.temp_replicas[rec.key] = (rec.old_value, rec.old_deleted)
                reverted += 1
            else:
                keep.append(rec)
        self.delta_buffer[proxy_id] = keep
        return reverted

    def prune_deltas(self, proxy_id: int, acked_watermark: int):
        buf = self.delta_buffer.get(proxy_id)
        if buf:
            self.delta_buffer[proxy_id] = [r for r in buf if r.seq > acked_watermark]

    # ------------------------------------------------------------------
    # mapping checkpoints (§5.3)
    # ------------------------------------------------------------------
    def should_checkpoint(self) -> bool:
        return self.mappings_since_ckpt >= self.mapping_ckpt_every

    def take_checkpoint(self) -> list[tuple[bytes, ChunkId, int]]:
        """Return (and clear) the mappings accumulated since the last
        checkpoint; the coordinator merges them into its persistent view."""
        out = self.mapping_log
        self.mapping_log = []
        self.mappings_since_ckpt = 0
        return out

    # ------------------------------------------------------------------
    # recovery helpers
    # ------------------------------------------------------------------
    def rebuild_indexes(self):
        """Rebuild both indexes from region contents (paper §3.2: indexes
        are local-only because they are reconstructible)."""
        self.object_index.clear()
        self.chunk_index.clear()
        for idx, (buf, cid) in enumerate(zip(self.region, self.chunk_ids)):
            if cid is None:
                continue
            self.chunk_index.insert(cid.pack(), idx)
            if cid.position < self.code.k:  # data chunk -> parse objects
                for off, key, value, deleted in parse_objects(buf):
                    if not deleted:
                        self.object_index.insert(
                            key, ObjectRef(idx, off, len(key), len(value)))

    def memory_bytes(self) -> dict:
        """Storage accounting for the redundancy benchmarks."""
        chunk_bytes = len(self.region) * self.chunk_size
        id_bytes = len(self.region) * 8
        obj_slots = self.object_index.num_buckets * 4
        chk_slots = self.chunk_index.num_buckets * 4
        replica_bytes = sum(len(k) + len(v) + 4 for k, (v, _) in self.temp_replicas.items())
        replica_bytes += sum(len(k) + len(v) + 4
                             for (k, _), (v, _) in self.zombie_replicas.items())
        return {
            "chunks": chunk_bytes,
            "chunk_ids": id_bytes,
            "object_index": obj_slots * 8,
            "chunk_index": chk_slots * 8,
            "replicas": replica_bytes,
        }
