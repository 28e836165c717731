"""MemEC cluster: normal-mode + degraded-mode request orchestration.

This module wires servers, proxies, and the coordinator into an in-process
cluster simulation with modeled network costs (``netsim``).  It implements
the full request workflows of paper §4.2 (SET/GET/UPDATE/DELETE), stripe
management §4.3, fault tolerance §5 (server states, backups, degraded
requests, migration after restore), and large-object fragmentation §3.2.

Implementation deviations from the paper (each noted inline):
* stripe IDs are assigned at chunk-open (not seal) time so SET acks can
  piggyback key->chunk-ID mappings (§5.3 requires the piggyback);
* DELETE of an unsealed object keeps a tombstoned (zero-valued) replica at
  parity servers instead of removing it, so seal-time chunk rebuild stays
  byte-identical;
* SET of an existing key routes through the UPDATE path (upsert) so a key
  never occupies two chunk slots — required for parity-side chunk rebuild;
* degraded UPDATE of an *unsealed* object shadows the new value at the
  redirected server (migrated back as a normal UPDATE on restore);
* overlapping-failure hardening beyond the paper's single-failure
  narrative (driven by tests/test_transitions_prop.py): redirect targets
  are sticky per (failed server, stripe list) and hand their degraded
  state off when they themselves fail; SET of an existing key in
  degraded mode routes through the mutate path (upsert); shadow replicas
  migrate to *every* restored parity server of a list.

Intra-shard async pipeline (PR 4): coding now carries a modeled cost
(``CostModel.coding_s`` over ``CodingEngine`` work bytes).  With
``async_engine=False`` (default, ``$MEMEC_ASYNC``) coding time adds
serially to a request's network phases; with ``async_engine=True`` the
store *submits* engine work (``engine.submit_*`` futures) while the same
shard's netsim legs are modeled in flight and charges
``max(coding, network)`` per phase — plus two further overlaps: the seal
fan-out runs concurrently with the SET acks, and ``multi_*`` requests
with ``proxy_id=None`` spread across the shard's proxies as concurrent
lanes (``NetSim.merge_lanes``; per-server serialization preserved).
Stored bytes are identical in both modes — only the synchronization
points and the latency accounting move.  ``stats["intra_overlap_saved_s"]``
tracks the genuine sync-vs-async win (phases the sync pipeline pays as a
sum); ``stats["proxy_lane_saved_s"]`` tracks lane overlap relative to
serially executed per-proxy calls (a different baseline — sync callers
issuing one batch per proxy call never pay that serialization).

Plan/execute decode + engine queue (PR 5): ``submit_decode`` now
dispatches on-device at submit on the jax/pallas backends (the engine
builds a ``DecodePlan`` from host metadata), so degraded reconstruction
(``_ensure_recon``) and ``fail_server`` batched recovery genuinely
overlap decode with their fetch legs; their share of the async win is
``stats["decode_overlap_saved_s"]``.  The degraded-mutate redirect
deltas are likewise computed through ONE submitted ``submit_delta`` call
merged with the redirect legs (they used to mutate recon chunks serially
with unmodeled cost).  Concurrent engine calls in one phase contend for
``CostModel.engine_depth`` lanes (default inf = the historical
no-contention merge); the extra wait a finite depth induces is
``stats["engine_queue_wait_s"]``.
"""
from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from .chunk import (CHUNK_SIZE, METADATA_SIZE, ChunkId, fragment_count,
                    object_size, parse_objects, split_fragments)
from .codes import Code, make_code
from .coordinator import Coordinator, ServerState
from .engine import CodingEngine, make_engine, resolve_async
from .hotkey import HotTier, resolve_hot_keys
from .index import fnv1a
from .netsim import CostModel, Leg, NetSim
from .proxy import Proxy
from .server import Server
from .stripe import StripeList, StripeMapper, generate_stripe_lists

LARGE_MAGIC = b"\x00MEMEC_LRG"

# dedicated hash seed for proxy-lane assignment: every occurrence of a
# key must land in the same lane (duplicate upserts keep request order),
# and the spread must stay independent of shard and stripe hashing
PROXY_LANE_SEED = 0x9e3779b9


def large_total(head: bytes | None) -> int | None:
    """Total payload size if ``head`` is a large-object manifest, else
    None — the one place that knows the manifest wire format."""
    if head is None or not head.startswith(LARGE_MAGIC):
        return None
    return struct.unpack("<I", head[len(LARGE_MAGIC):len(LARGE_MAGIC) + 4])[0]


class PartialFailure(Exception):
    """Raised by fault injection mid-request (testing §5.3 revert)."""


def resolve_redundant_reads(redundant_reads=None,
                            env: str = "MEMEC_REDUNDANT_READS") -> int:
    """Ctor arg wins; else ``$MEMEC_REDUNDANT_READS``; else 0 (the plain
    wait-for-every-chunk read path, bit-identical to history)."""
    if redundant_reads is None:
        redundant_reads = os.environ.get(env, "0") or "0"
    redundant_reads = int(redundant_reads)
    if redundant_reads < 0:
        raise ValueError(
            f"redundant_reads must be >= 0, got {redundant_reads}")
    return redundant_reads


@dataclasses.dataclass
class ReconChunk:
    """A chunk reconstructed on a redirected server (degraded mode)."""
    chunk_id: ChunkId
    buf: np.ndarray
    dirty: bool = False
    # for data chunks: key -> (offset, key_size, value_size, deleted)
    objects: dict | None = None

    def parse(self):
        self.objects = {}
        for off, key, value, deleted in parse_objects(self.buf):
            self.objects[key] = (off, len(key), len(value), deleted)

    def value_of(self, key: bytes) -> bytes | None:
        """A live object's bytes out of the reconstructed chunk."""
        entry = (self.objects or {}).get(key)
        if entry is None or entry[3]:
            return None
        off, ksz, vsz, _ = entry
        vo = off + METADATA_SIZE + ksz
        return self.buf[vo: vo + vsz].tobytes()


class RedirectStore:
    """Degraded-mode state held by a redirected server (§5.4)."""

    def __init__(self):
        self.temp_objects: dict[bytes, bytes] = {}   # degraded SET / shadows
        self.temp_deletes: set[bytes] = set()
        # shadow replicas for a failed parity: key -> (value, deleted,
        # instance seq) — the iseq disambiguates a same-instance mutation
        # from a delete/re-SET new instance when the state migrates back
        self.temp_replicas: dict[bytes, tuple[bytes, bool, int | None]] = {}
        self.recon: dict[tuple, ReconChunk] = {}     # chunk-id key -> chunk

    def clear(self):
        self.temp_objects.clear()
        self.temp_deletes.clear()
        self.temp_replicas.clear()
        self.recon.clear()


class MemECCluster:
    def __init__(self, num_servers: int = 16, num_proxies: int = 4,
                 scheme: str = "rs", n: int = 10, k: int = 8, c: int = 16,
                 chunk_size: int = CHUNK_SIZE, max_unsealed: int = 4,
                 cost: CostModel | None = None, degraded_enabled: bool = True,
                 verify_rebuild: bool = False, mapping_ckpt_every: int = 256,
                 engine: str | CodingEngine | None = None,
                 shard_id: int | None = None,
                 async_engine: bool | None = None,
                 arrival=None, trace=None,
                 redundant_reads: int | None = None,
                 hot_key_threshold: float | None = None,
                 hot_max_versions: int = 8, hot_max_keys: int = 64):
        self.shard_id = shard_id   # None when not part of a ShardedCluster
        # intra-shard async pipeline (None defers to $MEMEC_ASYNC): issue
        # coding through engine futures while netsim legs are in flight
        # and merge latencies as max(coding, network) instead of the sum
        self.async_engine = resolve_async(async_engine)
        self.code: Code = make_code(scheme, n, k)
        # one batched coding engine shared by every server and every
        # cluster-level batch operation (numpy | jax | pallas; see
        # core/engine.py and $MEMEC_ENGINE)
        self.engine: CodingEngine = make_engine(engine, self.code)
        self.n, self.k = self.code.n, self.code.k
        self.chunk_size = chunk_size
        self.stripe_lists = generate_stripe_lists(num_servers, self.n, self.k, c)
        self.mapper = StripeMapper(self.stripe_lists)
        self.servers = [Server(s, self.code, chunk_size, max_unsealed,
                               mapping_ckpt_every, engine=self.engine)
                        for s in range(num_servers)]
        self.proxies = [Proxy(p, self.mapper) for p in range(num_proxies)]
        self.num_proxies = num_proxies
        self.coordinator = Coordinator(num_servers, self.stripe_lists,
                                       shard_id=shard_id)
        # arrival: open-loop event mode ("poisson:RATE" / "uniform:RATE" /
        # "trace:..." / ArrivalProcess; None defers to $MEMEC_ARRIVAL,
        # default closed loop — see core/netsim.py EventRuntime)
        # trace: per-request span tracing ("1" / Tracer instance; None
        # defers to $MEMEC_TRACE, default off — see core/trace.py)
        self.net = NetSim(cost, arrival=arrival, trace=trace)
        # straggler-tolerant reads (Hydra-style late binding): GETs fan
        # out to k+Δ chunk candidates and complete at the k-th arrival,
        # treating the slowest Δ as a per-request erasure pattern for
        # DecodePlan.  Δ=0 (default) keeps the historical plain-k path
        # bit-identical (redundant_reads= / $MEMEC_REDUNDANT_READS).
        self.redundant_reads = resolve_redundant_reads(redundant_reads)
        # hot-key update tier (version-buffered delta coding): sealed
        # updates to keys whose EWMA update score reaches the threshold
        # buffer their version deltas instead of paying a parity round
        # per SET; the buffer collapses into ONE parity round at flush
        # (capacity, eviction, read barrier, failure, or
        # flush_hot_buffers()).  0/None = off — zero tier state and a
        # byte-identical baseline (hot_key_threshold= / $MEMEC_HOT_KEYS).
        self.hot_key_threshold = resolve_hot_keys(hot_key_threshold)
        self.hot = (HotTier(self.hot_key_threshold,
                            max_keys=hot_max_keys,
                            max_versions=hot_max_versions)
                    if self.hot_key_threshold > 0 else None)
        self.degraded_enabled = degraded_enabled
        self.verify_rebuild = verify_rebuild
        self.failed: set[int] = set()          # injected transient failures
        self.redirect: dict[int, RedirectStore] = {}
        # fault-injection hook: ("update"|"delete"|"set", key, parity_legs)
        self.crash_hook: tuple | None = None
        self._stats = {"reconstructions": 0, "recon_chunk_hits": 0,
                      "reverted_deltas": 0, "degraded_requests": 0,
                      "migrated_objects": 0, "migrated_chunks": 0,
                      "batch_recovered_chunks": 0, "redirect_handoffs": 0,
                      "modeled_coding_s": 0.0, "intra_overlap_saved_s": 0.0,
                      "proxy_lane_batches": 0, "proxy_lane_saved_s": 0.0,
                      "engine_queue_wait_s": 0.0,
                      "decode_overlap_saved_s": 0.0,
                      "redundant_reads": 0, "redundant_decodes": 0,
                      "redundant_cancelled": 0,
                      "redundant_replica_fallbacks": 0}

    @property
    def stats(self) -> dict:
        """Counter dict plus derived observability: per-kind latency
        percentiles (``latency[kind] = {count, mean_s, p50_s, p99_s,
        p999_s}``) and, in open-loop event mode, per-kind/per-resource
        queue-wait breakdowns plus the arrival descriptor."""
        out = dict(self._stats)
        if self.hot is not None:
            out["hot_tier"] = self.hot.snapshot()
        out["latency"] = self.net.latency_summary()
        if self.net.events is not None:
            ev = self.net.events.snapshot()
            out["arrival"] = ev["arrival"]
            out["queue_wait_s"] = ev["queue_wait_s"]
            out["queue_wait_s_by_kind"] = ev["queue_wait_s_by_kind"]
            out["queue_wait_s_by_resource"] = ev["queue_wait_s_by_resource"]
            out["event_makespan_s"] = ev["makespan_s"]
        return out

    @property
    def tracer(self):
        """The span tracer (None when tracing is off)."""
        return self.net.tracer

    def server_endpoint_names(self) -> list[str]:
        """Netsim endpoint labels of this cluster's storage servers."""
        return [f"s{i}" for i in range(len(self.servers))]

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _sv(self, sid: int) -> Server:
        return self.servers[sid]

    def _rs(self, sid: int) -> RedirectStore:
        return self.redirect.setdefault(sid, RedirectStore())

    def _is_failed(self, sid: int) -> bool:
        return sid in self.failed

    def _degraded_active(self, sid: int) -> bool:
        """True if requests touching sid must go through the coordinator."""
        return self.degraded_enabled and self.coordinator.state_of(sid) in (
            ServerState.INTERMEDIATE, ServerState.DEGRADED,
            ServerState.COORDINATED_NORMAL)

    def _positions(self, sl: StripeList) -> list[int]:
        return list(sl.servers)

    def _chunk_owner(self, sl: StripeList, position: int) -> int:
        return sl.servers[position]

    def _stripe_chunk_id(self, sl: StripeList, stripe_id: int, position: int) -> ChunkId:
        return ChunkId(sl.list_id, stripe_id, position)

    # ------------------------------------------------------------------
    # async-pipeline latency merging
    # ------------------------------------------------------------------
    def _overlap(self, *phase_times: float) -> float:
        """Merged duration of phases that the async pipeline overlaps
        (coding vs network legs, seal fan-out vs SET acks).  Sync mode
        runs them back to back — the historical sum."""
        if not self.async_engine:
            return sum(phase_times)
        t = max(phase_times, default=0.0)
        self._stats["intra_overlap_saved_s"] += sum(phase_times) - t
        return t

    def _trace_frame(self):
        """Open a span frame for the request about to execute (returns
        the tracer, or None when tracing is off — the zero-cost path)."""
        tr = self.net.tracer
        if tr is not None:
            tr.push()
        return tr

    def _overlap_branches(self, *branches) -> float:
        """``_overlap`` over named thunks (``(name, fn)``), grouping each
        branch's spans when tracing (e.g. seal fan-out vs SET acks)."""
        tr = self.net.tracer
        if tr is None:
            return self._overlap(*(fn() for _, fn in branches))
        entries = []
        for name, fn in branches:
            tr.push()
            dur = fn()
            entries.append((name, dur, tr.pop()))
        t = self._overlap(*(dur for _, dur, _ in entries))
        tr.overlap(t, entries, self.async_engine)
        return t

    def _merge_coding(self, coding_s: float, net_s: float,
                      kind: str | None = None,
                      lane_durs: list[float] | None = None,
                      queue_wait_s: float = 0.0) -> float:
        """Coding vs in-flight netsim legs: serial in sync mode,
        max(coding, network) in async mode.  ``kind="decode"`` phases
        additionally track their share of the async win in
        ``stats["decode_overlap_saved_s"]`` (a subset of
        ``intra_overlap_saved_s`` — the read-repair overlap)."""
        self._stats["modeled_coding_s"] += coding_s
        # event-mode demand capture: the in-flight request's engine-busy
        # seconds (gates later submits on the engine lanes) + the shard
        # engine's cumulative modeled-busy clock (idle-engine planning).
        # Demand excludes the intra-phase makespan wait (queue_wait_s):
        # that wait is already inside the service latency via
        # engine_queue_wait_s, so forwarding the full makespan would
        # price the same depth contention twice (once per phase, again
        # as event-mode lane occupancy in queue_wait_s_by_resource).
        self.net.note_coding(coding_s - queue_wait_s)
        self.engine.note_modeled_busy(coding_s)
        t = self._overlap(coding_s, net_s)
        if self.async_engine and kind == "decode":
            self._stats["decode_overlap_saved_s"] += coding_s + net_s - t
        tr = self.net.tracer
        if tr is not None and (coding_s > 0.0 or net_s > 0.0):
            tr.merge_coding(coding_s, net_s, t, kind, lane_durs,
                            self.net.cost.engine_depth, self.async_engine)
        return t

    def _merge_coding_calls(self, durs: list[float], net_s: float,
                            kind: str | None = None) -> float:
        """Several engine calls submitted in one overlapped phase
        contend for the shard engine's ``CostModel.engine_depth`` lanes:
        the phase's coding duration is the depth-limited makespan (== the
        historical max at the default infinite depth), with the extra
        wait surfaced in ``stats["engine_queue_wait_s"]``."""
        durs = [d for d in durs if d > 0]
        span = self.net.cost.engine_makespan(durs)
        wait = span - max(durs) if durs else 0.0
        self._stats["engine_queue_wait_s"] += wait
        return self._merge_coding(span, net_s, kind, lane_durs=durs,
                                  queue_wait_s=wait)

    def _coding_s(self, fut) -> float:
        """Modeled duration of a submitted engine call."""
        if fut is None:
            return 0.0
        return self.net.cost.coding_s(fut.work_bytes)

    # ------------------------------------------------------------------
    # normal-mode seal fan-out (data server -> parity servers)
    # ------------------------------------------------------------------
    def _handle_seals(self, sl: StripeList, ds: int, events) -> float:
        return self._handle_seals_batched([(sl, ds, ev) for ev in events])

    def _handle_seals_batched(self, items: list[tuple]) -> float:
        """Fan seal events out to parity servers, folding each parity
        server's whole batch of rebuilt chunks through one engine call.
        ``items``: (stripe_list, data_server, SealEvent) triples — possibly
        from different stripe lists (multi-key SETs).

        Coding is *submitted* before the seal legs are modeled: distinct
        parity servers fold concurrently up to the engine queue's depth
        (their coding phase is the depth-limited makespan — the plain
        max at the default infinite ``CostModel.engine_depth``), and the
        async pipeline overlaps that fold with the in-flight seal legs
        (``max(coding, network)``; serial in sync mode)."""
        t = 0.0
        legs = []
        per_parity: dict[int, list[tuple]] = {}
        for sl, ds, ev in items:
            for p in sl.parity_servers:
                if self._is_failed(p) and self._degraded_active(p):
                    t += self._seal_to_failed_parity(sl, ds, ev, p)
                    continue
                legs.append(Leg("seal", ev.payload_bytes, f"s{ds}", f"s{p}",
                                self._is_failed(p)))
                per_parity.setdefault(p, []).append((sl, ds, ev))
        folds = [(p, pitems, *self._sv(p).submit_fold_seals(
                    [ev for _, _, ev in pitems]))
                 for p, pitems in per_parity.items()]
        net_t = self.net.phase(legs) if legs else 0.0
        durs = [self._coding_s(fut) for _, _, fut, _ in folds]
        for p, pitems, fut, finish in folds:
            rebuilts = finish()
            if self.verify_rebuild:
                for (sl, ds, ev), rebuilt in zip(pitems, rebuilts):
                    src = self._sv(ds).get_sealed_chunk(ev.chunk_id)
                    assert src is not None and np.array_equal(rebuilt, src), \
                        "parity rebuild mismatch"
        if folds or legs:
            t += self._merge_coding_calls(durs, net_t, kind="seal")
        return t

    def _seal_to_failed_parity(self, sl: StripeList, ds: int, ev, failed_p: int) -> float:
        """Seal while a parity server is down: recompute that parity row on
        the redirected server from the k data chunks (costly but correct —
        the failed parity's replicas are unreachable)."""
        r = self.coordinator.redirected_server(sl, failed_p)
        rs = self._rs(r)
        t = 0.0
        data = np.zeros((self.k, self.chunk_size), np.uint8)
        legs = []
        for i in range(self.k):
            c, src = self._best_data_chunk(sl, ev.chunk_id.stripe_id, i)
            if c is not None:
                data[i] = c
            legs.append(Leg("recon_fetch", self.chunk_size, f"s{src}", f"s{r}"))
        fut = self.engine.submit_encode(data[None])
        t += self._merge_coding(self._coding_s(fut), self.net.phase(legs),
                                kind="seal")
        parity = fut.result()[0]
        ppos = sl.parity_servers.index(failed_p)
        cid = self._stripe_chunk_id(sl, ev.chunk_id.stripe_id, self.k + ppos)
        rc = ReconChunk(cid, parity[ppos].copy(), dirty=True)
        rs.recon[cid.key()] = rc
        self._stats["reconstructions"] += 1
        return t

    def _maybe_checkpoint(self, ds: int) -> float:
        srv = self._sv(ds)
        if not srv.should_checkpoint():
            return 0.0
        mappings = srv.take_checkpoint()
        payload = sum(len(k) + 12 for k, _, _ in mappings)
        t = self.net.phase([Leg("mapping_ckpt", payload, f"s{ds}", "coord")])
        self.coordinator.store_checkpoint(ds, mappings)
        legs = [Leg("ckpt_ack", 8, f"s{ds}", f"p{p.pid}") for p in self.proxies]
        t += self.net.phase(legs)
        for p in self.proxies:
            p.clear_mappings(ds)
        return t

    # ------------------------------------------------------------------
    # public request API (routed through a proxy)
    # ------------------------------------------------------------------
    def peek_value(self, key: bytes) -> bytes | None:
        """Degraded-aware local read of a key's stored bytes with NO
        netsim accounting — for control-plane probes (upsert head checks,
        migration planning/transfer), not client requests.  Resolves a
        failed data server through the redirect state: shadowed objects,
        the batched-decode reconstruction cache, then a parity replica."""
        sl, ds = self.mapper.data_server_for(key)
        if not (self._is_failed(ds) and self._degraded_active(ds)):
            return self._sv(ds).get_value(key)
        r = self.coordinator.redirected_server(sl, ds)
        rs = self._rs(r)
        if key in rs.temp_deletes:
            return None
        if key in rs.temp_objects:
            return rs.temp_objects[key]
        cid = self.coordinator.chunk_id_for(ds, key)
        if cid is None:
            return None
        rc = rs.recon.get(cid.key())
        if rc is not None:
            return rc.value_of(key)
        for p in sl.parity_servers:
            if not self._is_failed(p):
                rep = self._sv(p).get_replica(key)
                if rep is None:
                    break
                value, deleted = rep
                return None if deleted else value
        return None

    def set(self, key: bytes, value: bytes, proxy_id: int = 0):
        # upsert over a large object tears the old fragments down first —
        # overwriting only the manifest head would orphan them.  The probe
        # is data-server-local (no modeled legs, like _set_small's upsert
        # lookup) and copies only manifest-sized head bytes on the normal
        # path; a failed data server resolves through the degraded view.
        sl, ds = self.mapper.data_server_for(key)
        head = None
        if self._is_failed(ds) and self._degraded_active(ds):
            head = self.peek_value(key)
        else:
            srv = self._sv(ds)
            ref = srv.lookup(key)
            if ref is not None:
                vo = ref.value_offset
                n = min(ref.value_size, len(LARGE_MAGIC) + 4)
                head = srv.region[ref.chunk_local_idx][vo: vo + n].tobytes()
        if large_total(head) is not None:
            self.delete(key, proxy_id)
        if object_size(len(key), len(value)) > self.chunk_size:
            return self._set_large(key, value, proxy_id)
        return self._set_small(key, value, proxy_id)

    def get(self, key: bytes, proxy_id: int = 0):
        v = self._get_small(key, proxy_id)
        total = large_total(v)
        if total is not None:
            return self._get_large(key, total, proxy_id)
        return v

    def update(self, key: bytes, value: bytes, proxy_id: int = 0) -> bool:
        head = self._get_small(key, proxy_id)
        if head is not None and head.startswith(LARGE_MAGIC):
            return self._update_large(key, value, proxy_id)
        return self._update_small(key, value, proxy_id)

    def delete(self, key: bytes, proxy_id: int = 0) -> bool:
        head = self._get_small(key, proxy_id)
        if head is not None and head.startswith(LARGE_MAGIC):
            return self._delete_large(key, head, proxy_id)
        return self._delete_small(key, proxy_id)

    # ------------------------------------------------------------------
    # batched multi-key API — amortizes coding (one engine call per
    # batch) and netsim legs (one fan-out phase per batch).  Keys that
    # need special handling (degraded stripes, large objects, upserts,
    # in-batch duplicates) fall back to the single-key workflows, so the
    # batched paths stay byte-identical with sequential execution.
    #
    # ``proxy_id=None`` spreads the batch across this cluster's proxies
    # as per-key-hash lanes (every occurrence of a key stays in one lane,
    # preserving per-key request order); with the async pipeline the
    # lanes' modeled latencies overlap (``NetSim.merge_lanes``, busiest
    # shared server as the serialization floor), in sync mode they run
    # back to back.
    # ------------------------------------------------------------------
    def _proxy_lanes(self, keys) -> list[tuple[int, list[int]]]:
        lanes: dict[int, list[int]] = {}
        for i, key in enumerate(keys):
            pid = fnv1a(key, seed=PROXY_LANE_SEED) % self.num_proxies
            lanes.setdefault(pid, []).append(i)
        return sorted(lanes.items())

    def _run_proxy_lanes(self, kind: str, keys, impl) -> list:
        """``impl(idxs, pid) -> (results, t|None)``; results merge back in
        request order, lane latencies merge into one facade record."""
        results: list = [None] * len(keys)
        dts: list[float] = []
        busys: list[dict] = []
        tr = self._trace_frame()
        lane_tr: list[tuple] = []
        for pid, idxs in self._proxy_lanes(keys):
            b0 = self.net.busy_snapshot()
            if tr is not None:
                tr.push()
            res, t = impl(idxs, pid)
            segs = tr.pop() if tr is not None else None
            for i, v in zip(idxs, res):
                results[i] = v
            if t is not None:
                dts.append(t)
                busys.append(NetSim.busy_delta(b0, self.net.busy_snapshot()))
                lane_tr.append((pid, t, segs))
        if dts:
            if self.async_engine and len(dts) > 1:
                merged = NetSim.merge_lanes(dts, busys)
                # savings vs *serially executed lanes* (what sequential
                # per-proxy multi_* calls would have cost) — tracked
                # apart from intra_overlap_saved_s, which only counts
                # overlaps the sync pipeline genuinely pays as a sum
                # (coding vs legs, seal fan-out vs acks)
                self._stats["proxy_lane_saved_s"] += sum(dts) - merged
            else:
                merged = sum(dts)
            if len(dts) > 1:
                self._stats["proxy_lane_batches"] += 1
            if tr is not None:
                tr.lanes(merged, lane_tr,
                         par=self.async_engine and len(dts) > 1)
            self.net.record(kind, merged)
        elif tr is not None:
            tr.cancel()
        return results

    def multi_get(self, keys, proxy_id: int | None = 0) -> list:
        keys = list(keys)
        if proxy_id is None and self.num_proxies > 1 and len(keys) > 1:
            return self._run_proxy_lanes(
                "MGET", keys,
                lambda idxs, pid: self._multi_get_impl(
                    [keys[i] for i in idxs], pid))
        tr = self._trace_frame()
        out, t = self._multi_get_impl(keys, proxy_id or 0)
        if t is not None:
            self.net.record("MGET", t)
        elif tr is not None:
            tr.cancel()
        return out

    def _multi_get_impl(self, keys, proxy_id: int):
        proxy = self.proxies[proxy_id]
        out: list = [None] * len(keys)
        plan = []
        for i, key in enumerate(keys):
            sl, ds = self.mapper.data_server_for(key)
            if self._is_failed(ds) and self._degraded_active(ds):
                out[i] = self.get(key, proxy_id)       # degraded fallback
            else:
                plan.append((i, key, sl, ds))
        t = None
        if plan:
            if self.redundant_reads > 0 and self.code.m > 0:
                vals, t = self._coded_read_batch(
                    proxy, [(key, sl, ds) for _, key, sl, ds in plan])
                for (i, _, _, _), v in zip(plan, vals):
                    out[i] = v
            else:
                t = self.net.phase([Leg("get", len(key), f"p{proxy.pid}",
                                        f"s{ds}", self._is_failed(ds))
                                    for _, key, _, ds in plan])
                resp_legs = []
                for i, key, _, ds in plan:
                    v = self._sv(ds).get_value(key)
                    resp_legs.append(Leg("get_resp", len(v) if v else 0,
                                         f"s{ds}", f"p{proxy.pid}",
                                         self._is_failed(ds)))
                    out[i] = v
                t += self.net.phase(resp_legs)
            for i, key, _, ds in plan:  # large objects: fetch fragments
                total = large_total(out[i])
                if total is not None:
                    out[i] = self._get_large(key, total, proxy_id)
        return out, t

    def multi_set(self, items, proxy_id: int | None = 0) -> list[bool]:
        items = list(items)
        if proxy_id is None and self.num_proxies > 1 and len(items) > 1:
            return self._run_proxy_lanes(
                "MSET", [k for k, _ in items],
                lambda idxs, pid: self._multi_set_impl(
                    [items[i] for i in idxs], pid))
        tr = self._trace_frame()
        ok, t = self._multi_set_impl(items, proxy_id or 0)
        if t is not None:
            self.net.record("MSET", t)
        elif tr is not None:
            tr.cancel()
        return ok

    def _multi_set_impl(self, items, proxy_id: int):
        proxy = self.proxies[proxy_id]
        ok = [False] * len(items)
        batch, deferred, seen = [], [], set()
        for i, (key, value) in enumerate(items):
            sl, ds = self.mapper.data_server_for(key)
            involved = [ds] + list(sl.parity_servers)
            if key in seen:
                deferred.append((i, key, value))       # keep batch order
            elif (object_size(len(key), len(value)) > self.chunk_size
                  or any(self._degraded_active(s) and self._is_failed(s)
                         for s in involved)
                  or self._sv(ds).lookup(key) is not None):
                ok[i] = self.set(key, value, proxy_id)  # fallback
            else:
                seen.add(key)
                batch.append((i, key, value, sl, ds))
        t = None
        if batch:
            t = 0.0
            reqs, legs = [], []
            for i, key, value, sl, ds in batch:
                reqs.append(proxy.begin("SET", key, value, sl, ds))
                obj = object_size(len(key), len(value))
                legs.append(Leg("set", obj, f"p{proxy.pid}", f"s{ds}",
                                self._is_failed(ds)))
                legs += [Leg("set_replica", obj, f"p{proxy.pid}", f"s{p}",
                             self._is_failed(p)) for p in sl.parity_servers]
            t += self.net.phase(legs)
            seal_items, ack_legs, touched = [], [], []
            for (i, key, value, sl, ds), req in zip(batch, reqs):
                cid, off, events = self._sv(ds).set_object(sl, key, value)
                iseq = self._sv(ds).live_iseq(key)
                for p in sl.parity_servers:
                    self._sv(p).store_replica(key, value, iseq=iseq)
                seal_items += [(sl, ds, ev) for ev in events]
                ack_legs.append(Leg("set_ack", len(key) + 8, f"s{ds}",
                                    f"p{proxy.pid}", self._is_failed(ds)))
                ack_legs += [Leg("set_ack", 8, f"s{p}", f"p{proxy.pid}",
                                 self._is_failed(p))
                             for p in sl.parity_servers]
                proxy.buffer_mapping(ds, key, cid, iseq)
                touched.append(ds)
                ok[i] = True
            # async: the seal fan-out (parity rebuild + fold) overlaps
            # the SET acknowledgements already in flight
            t += self._overlap_branches(
                ("seal", lambda: self._handle_seals_batched(seal_items)),
                ("ack", lambda: self.net.phase(ack_legs)))
            for req in reqs:
                proxy.ack(req.seq)
            for ds in dict.fromkeys(touched):
                t += self._maybe_checkpoint(ds)
        for i, key, value in deferred:   # duplicate keys: now upserts
            ok[i] = self.set(key, value, proxy_id)
        return ok, t

    def multi_update(self, items, proxy_id: int | None = 0) -> list[bool]:
        items = list(items)
        if self.crash_hook is not None and self.crash_hook[0] == "update":
            # fault injection must fire exactly as in sequential mode:
            # everything before the crashing key completes first, the
            # crash raises, and nothing after it executes
            hook_i = next((i for i, (k, _) in enumerate(items)
                           if k == self.crash_hook[1]), None)
            if hook_i is not None:
                hook_pid = proxy_id if proxy_id is not None else 0
                ok = [False] * len(items)
                ok[:hook_i] = self.multi_update(items[:hook_i], proxy_id)
                ok[hook_i] = self.update(*items[hook_i], hook_pid)
                ok[hook_i + 1:] = self.multi_update(items[hook_i + 1:],
                                                    proxy_id)
                return ok
        if proxy_id is None and self.num_proxies > 1 and len(items) > 1:
            return self._run_proxy_lanes(
                "MUPDATE", [k for k, _ in items],
                lambda idxs, pid: self._multi_update_impl(
                    [items[i] for i in idxs], pid))
        tr = self._trace_frame()
        ok, t = self._multi_update_impl(items, proxy_id or 0)
        if t is not None:
            self.net.record("MUPDATE", t)
        elif tr is not None:
            tr.cancel()
        return ok

    def _multi_update_impl(self, items, proxy_id: int):
        proxy = self.proxies[proxy_id]
        ok = [False] * len(items)
        batch, deferred, seen = [], [], set()
        for i, (key, value) in enumerate(items):
            sl, ds = self.mapper.data_server_for(key)
            involved = [ds] + list(sl.parity_servers)
            if key in seen:
                deferred.append((i, key, value))
                continue
            if any(self._degraded_active(s) and self._is_failed(s)
                   for s in involved):
                ok[i] = self.update(key, value, proxy_id)  # degraded
                continue
            head = self._sv(ds).get_value(key)
            if head is not None and head.startswith(LARGE_MAGIC):
                ok[i] = self._update_large(key, value, proxy_id)
                continue
            seen.add(key)
            batch.append((i, key, value, sl, ds, head))
        t = None
        if batch:
            # head-probe round trip (sequential update() pays a modeled
            # GET per key before choosing the update path — charge the
            # batched equivalent so MUPDATE stays comparable)
            t = self.net.phase([Leg("get", len(key), f"p{proxy.pid}",
                                    f"s{ds}", self._is_failed(ds))
                                for _, key, _, _, ds, _ in batch])
            t += self.net.phase([Leg("get_resp",
                                     len(head) if head else 0, f"s{ds}",
                                     f"p{proxy.pid}", self._is_failed(ds))
                                 for _, _, _, _, ds, head in batch])
            t += self.net.phase([Leg("update", len(key) + len(value),
                                     f"p{proxy.pid}", f"s{ds}",
                                     self._is_failed(ds))
                                 for _, key, value, _, ds, _ in batch])
            sealed_jobs, replica_jobs, done_reqs = [], [], []
            for i, key, value, sl, ds, _head in batch:
                req = proxy.begin("UPDATE", key, value, sl, ds)
                res = self._sv(ds).update_value(key, value)
                if res is None:
                    proxy.ack(req.seq)
                    continue
                cid, sealed, off, xor = res
                nz = np.nonzero(xor)[0]
                if len(nz):
                    seg_off = off + int(nz[0])
                    seg = xor[int(nz[0]): int(nz[-1]) + 1]
                else:
                    seg_off, seg = off, xor[:0]
                if sealed:
                    if (self._hot_eligible() and self._hot_buffer_update(
                            key, sl, ds, cid, seg_off, seg)):
                        pass   # hot key: parity round deferred to flush
                    else:
                        sealed_jobs.append((sl, ds, cid, seg_off, seg, req))
                else:
                    replica_jobs.append((sl, ds, key, value, req))
                done_reqs.append(req)
                ok[i] = True
            legs = []
            fut = None
            old_par = None
            if sealed_jobs:
                # one *submitted* engine call computes AND folds every
                # parity row of every updated chunk (fused delta+apply —
                # no separate (B, m, C) delta materialization); the delta
                # legs are modeled while it is in flight
                fulls = np.zeros((len(sealed_jobs), self.chunk_size),
                                 np.uint8)
                for b, (sl, ds, cid, seg_off, seg, req) in enumerate(sealed_jobs):
                    fulls[b, seg_off: seg_off + len(seg)] = seg
                positions = np.array(
                    [cid.position for _, _, cid, _, _, _ in sealed_jobs])
                old_par = np.stack(
                    [np.stack([self._sv(p).parity_row(sl, cid.stripe_id)
                               for p in sl.parity_servers])
                     for sl, ds, cid, _, _, _ in sealed_jobs])
                fut = self.engine.submit_apply_delta(old_par, positions,
                                                     fulls)
                for sl, ds, cid, seg_off, seg, req in sealed_jobs:
                    legs += [Leg("delta", len(seg), f"s{ds}", f"s{p}",
                                 self._is_failed(p))
                             for p in sl.parity_servers]
            for sl, ds, key, value, req in replica_jobs:
                for p in sl.parity_servers:
                    self._sv(p).apply_replica_delta(key, value, False,
                                                    proxy.pid, req.seq)
                    legs.append(Leg("replica_delta", len(key) + len(value),
                                    f"s{ds}", f"s{p}", self._is_failed(p)))
            net_t = self.net.phase(legs) if legs else 0.0
            if fut is not None:
                # per-row deltas (new ^ old) feed the §5.3 revert buffer;
                # extraction is stale-proof even when two jobs share a
                # stripe's parity slot — the delta never depends on the
                # gathered parity content
                deltas = fut.result() ^ old_par
                for (sl, ds, cid, seg_off, seg, req), delta in zip(
                        sealed_jobs, deltas):
                    for j, p in enumerate(sl.parity_servers):
                        self._sv(p).apply_data_delta_row(
                            sl, cid, delta[j], proxy.pid, req.seq)
            if legs or fut is not None:
                t += self._merge_coding(self._coding_s(fut), net_t,
                                        kind="delta")
            t += self.net.phase([Leg("update_ack", 8, f"s{ds}",
                                     f"p{proxy.pid}", self._is_failed(ds))
                                 for _, _, _, _, ds, _ in batch])
            parity_set = {p for _, _, _, sl, _, _ in batch
                          for p in sl.parity_servers}
            for req in done_reqs:
                proxy.ack(req.seq)
            for p in parity_set:
                self._sv(p).prune_deltas(proxy.pid, proxy.ack_watermark)
        for i, key, value in deferred:
            ok[i] = self.update(key, value, proxy_id)
        return ok, t

    # ------------------------------------------------------------------
    # SET
    # ------------------------------------------------------------------
    def _set_small(self, key: bytes, value: bytes, proxy_id: int):
        proxy = self.proxies[proxy_id]
        sl, ds = self.mapper.data_server_for(key)
        involved = [ds] + list(sl.parity_servers)
        if any(self._degraded_active(s) and self._is_failed(s) for s in involved):
            return self._degraded_set(proxy, sl, ds, key, value)
        req = proxy.begin("SET", key, value, sl, ds)
        t = 0.0
        # upsert: a key must never occupy two chunk slots (see module doc)
        if self._sv(ds).lookup(key) is not None:
            ref = self._sv(ds).lookup(key)
            if ref.value_size == len(value):
                proxy.ack(req.seq)
                return self._update_small(key, value, proxy_id)
            self._delete_small(key, proxy_id)
        self._trace_frame()
        obj_bytes = object_size(len(key), len(value))
        legs = [Leg("set", obj_bytes, f"p{proxy.pid}", f"s{ds}", self._is_failed(ds))]
        for p in sl.parity_servers:
            legs.append(Leg("set_replica", obj_bytes, f"p{proxy.pid}", f"s{p}",
                            self._is_failed(p)))
        t += self.net.phase(legs)
        cid, off, seal_events = self._sv(ds).set_object(sl, key, value)
        iseq = self._sv(ds).live_iseq(key)
        for p in sl.parity_servers:
            self._sv(p).store_replica(key, value, iseq=iseq)
        # acks (data server piggybacks the key->chunk-ID mapping, §5.3);
        # async overlaps the seal fan-out with the acks in flight
        ack_legs = [Leg("set_ack", len(key) + 8, f"s{ds}", f"p{proxy.pid}",
                        self._is_failed(ds))]
        ack_legs += [Leg("set_ack", 8, f"s{p}", f"p{proxy.pid}", self._is_failed(p))
                     for p in sl.parity_servers]
        t += self._overlap_branches(
            ("seal", lambda: self._handle_seals(sl, ds, seal_events)),
            ("ack", lambda: self.net.phase(ack_legs)))
        proxy.buffer_mapping(ds, key, cid, iseq)
        t += self._maybe_checkpoint(ds)
        proxy.ack(req.seq)
        self.net.record("SET", t)
        return True

    def _set_large(self, key: bytes, value: bytes, proxy_id: int):
        frags = split_fragments(key, value, self.chunk_size)
        for fkey, fval in frags:
            self._set_small(fkey, fval, proxy_id)
        manifest = LARGE_MAGIC + struct.pack("<I", len(value))
        return self._set_small(key, manifest, proxy_id)

    # ------------------------------------------------------------------
    # GET
    # ------------------------------------------------------------------
    def _endpoint_load(self, sid: int) -> float:
        """Load-aware chunk selection score for one server: cumulative
        link occupancy (``time_by_endpoint``) plus, in open-loop event
        mode, the link's current free-at clock — so redundant fetches
        avoid the busiest endpoints.  An inflated straggler's occupancy
        grows ``factor``x faster, so selection learns to deprioritize it
        without being told (the races hide it meanwhile).  Within one
        shard every candidate shares the engine, so the
        ``CodingEngine.modeled_busy_s`` half of load-awareness lives at
        the cross-shard ``_scatter`` seam (idle-engine preference)."""
        ep = f"s{sid}"
        load = self.net.time_by_endpoint.get(ep, 0.0)
        if self.net.events is not None:
            load += self.net.events.link_free.get(ep, 0.0)
        return load

    def _coded_read_batch(self, proxy, entries):
        """Straggler-tolerant k-of-(k+Δ) GET fan-out (Hydra-style late
        binding; Δ = ``redundant_reads``).

        Per ``(key, sl, ds)`` entry, pick the read mode:

        * sealed object — race the data server's value response against
          the k-1+Δ least-loaded other stripe members returning their
          full chunks; the request completes at the k-th arrival.  If
          the data server is among the dropped Δ, the winners' chunk set
          flows into ``DecodePlan`` as a per-request erasure pattern
          (one batched ``submit_decode`` across the whole batch).
        * unsealed object — race the data server against Δ of its alive
          parity replicas (unsealed objects are replicated there).
        * miss — nothing to race; a single round trip, cost-identical
          to the plain path.

        Dark servers (failed + degraded-active) are excluded from the
        candidate set, so Δ race-erasures plus real erasures can never
        exceed m; merely-slow or failed-but-undeclared servers stay in
        and lose the race naturally.  Dropped legs are fully accounted
        (bytes, messages, link occupancy — future requests queue behind
        them) but never gate this request's completion and appear as
        cancelled spans in the tracer, not latency contributors.

        Returns ``(values, modeled_t)``; races of one batch run
        concurrently (t = max over entries, like the plain batched
        fan-out phases).
        """
        if self.hot is not None and len(self.hot.buffer):
            # read barrier: the sealed races below may read parity
            # chunks of these stripes — collapse any buffered hot-key
            # deltas owed to them first, so decode sees consistent parity
            stripes = []
            for key, sl, ds in entries:
                srv = self._sv(ds)
                ref = srv.lookup(key)
                if ref is not None and srv.sealed[ref.chunk_local_idx]:
                    stripes.append((sl, srv.chunk_id_of(ref)))
            self._hot_barrier_stripes(stripes)
        delta = self.redundant_reads
        pp = f"p{proxy.pid}"
        vals: list = [None] * len(entries)
        race_ts: list[float] = []
        decode_jobs = []   # (slot, key, cid, pos, available, expected)
        tr = self.net.tracer
        if tr is not None:
            tr.push()
        for slot, (key, sl, ds) in enumerate(entries):
            srv = self._sv(ds)
            ref = srv.lookup(key)
            failed_ds = self._is_failed(ds)
            v = srv.get_value(key)
            vsz = len(v) if v else 0
            primary = (f"get:{pp}->s{ds}",
                       [Leg("get", len(key), pp, f"s{ds}", failed_ds),
                        Leg("get_resp", vsz, f"s{ds}", pp, failed_ds)])
            if ref is None:
                # miss/deleted: one round trip, cost-identical to plain
                t, _, _ = self.net.race_phase([primary], need=1)
                race_ts.append(t)
                vals[slot] = v
                continue
            if not srv.sealed[ref.chunk_local_idx]:
                # unsealed: replicated at every alive parity server
                cands = sorted(
                    (self._endpoint_load(p), p) for p in sl.parity_servers
                    if not (self._is_failed(p) and self._degraded_active(p)))
                cands = cands[:delta]
                groups = [primary]
                for _, p in cands:
                    fp = self._is_failed(p)
                    groups.append(
                        (f"rget:{pp}->s{p}",
                         [Leg("rget", len(key), pp, f"s{p}", fp),
                          Leg("rget_resp", vsz, f"s{p}", pp, fp)]))
                if len(groups) > 1:
                    self._stats["redundant_reads"] += 1
                t, winners, dropped = self.net.race_phase(groups, need=1)
                race_ts.append(t)
                self._stats["redundant_cancelled"] += len(dropped)
                if winners == [0]:
                    vals[slot] = v
                else:
                    rep = self._sv(cands[winners[0] - 1][1]).get_replica(key)
                    if rep is None:
                        self._stats["redundant_replica_fallbacks"] += 1
                        vals[slot] = v
                    else:
                        rv, deleted = rep
                        vals[slot] = None if deleted else rv
                continue
            # sealed: race the stripe (data-position chunks preferred —
            # deterministic (load, is_parity, position) ranking)
            cid = srv.chunk_id_of(ref)
            pos = cid.position
            cand_pos = sorted(
                (self._endpoint_load(owner), i >= self.k, i)
                for i, owner in enumerate(sl.servers)
                if i != pos and not (self._is_failed(owner)
                                     and self._degraded_active(owner)))
            take = cand_pos[: self.k - 1 + delta]
            groups, members = [primary], [pos]
            for _, _, i in take:
                owner = self._chunk_owner(sl, i)
                fo = self._is_failed(owner)
                groups.append(
                    (f"rget:{pp}->s{owner}",
                     [Leg("rget", len(key), pp, f"s{owner}", fo),
                      Leg("rget_resp", self.chunk_size, f"s{owner}", pp,
                          fo)]))
                members.append(i)
            if len(groups) > 1:
                self._stats["redundant_reads"] += 1
            t, winners, dropped = self.net.race_phase(
                groups, need=min(self.k, len(groups)))
            race_ts.append(t)
            self._stats["redundant_cancelled"] += len(dropped)
            if 0 in winners:
                vals[slot] = v
            else:
                # the data server lost the race: its position is this
                # request's erasure; decode from the k chunk winners
                # (sealed-or-zero, mirroring _gather_available)
                available = {}
                for gi in winners:
                    i = members[gi]
                    c = self._sv(self._chunk_owner(sl, i)).get_sealed_chunk(
                        self._stripe_chunk_id(sl, cid.stripe_id, i))
                    available[i] = (c if c is not None else
                                    np.zeros(self.chunk_size, np.uint8))
                decode_jobs.append((slot, key, cid, pos, available, v))
        max_t = max(race_ts, default=0.0)
        if tr is not None:
            tr.par("races", max_t, tr.pop())
        if not decode_jobs:
            return vals, max_t
        self._stats["redundant_decodes"] += len(decode_jobs)
        fut = self.engine.submit_decode(
            [av for _, _, _, _, av, _ in decode_jobs],
            [[pos] for _, _, _, pos, _, _ in decode_jobs],
            self.chunk_size)
        t_total = self._merge_coding(self._coding_s(fut), max_t,
                                     kind="decode")
        for (slot, key, cid, pos, _, expected), rec in zip(
                decode_jobs, fut.result()):
            rc = ReconChunk(cid, np.array(rec[pos], np.uint8))
            rc.parse()
            vals[slot] = rc.value_of(key)
            if self.verify_rebuild:
                assert vals[slot] == expected, \
                    f"race decode diverged for {key!r}"
        return vals, t_total

    def _get_small(self, key: bytes, proxy_id: int):
        proxy = self.proxies[proxy_id]
        sl, ds = self.mapper.data_server_for(key)
        if self._is_failed(ds) and self._degraded_active(ds):
            return self._degraded_get(proxy, sl, ds, key)
        if self.redundant_reads > 0 and self.code.m > 0:
            # straggler-tolerant k-of-(k+Δ) read (contents byte-identical
            # to the plain path; only the who-answers race differs)
            self._trace_frame()
            vals, t = self._coded_read_batch(proxy, [(key, sl, ds)])
            self.net.record("GET", t)
            return vals[0]
        self._trace_frame()
        t = self.net.phase([Leg("get", len(key), f"p{proxy.pid}", f"s{ds}",
                                self._is_failed(ds))])
        v = self._sv(ds).get_value(key)
        t += self.net.phase([Leg("get_resp", len(v) if v else 0, f"s{ds}",
                                 f"p{proxy.pid}", self._is_failed(ds))])
        self.net.record("GET", t)
        return v

    def _get_large(self, key: bytes, total: int, proxy_id: int):
        nfrag = fragment_count(total, len(key), self.chunk_size)
        parts = []
        for i in range(nfrag):
            fkey = key + struct.pack("<I", i)
            part = self._get_small(fkey, proxy_id)
            if part is None:
                return None
            parts.append(part)
        return b"".join(parts)[:total]

    # ------------------------------------------------------------------
    # UPDATE / DELETE (shared delta fan-out)
    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # hot-key update tier (version-buffered delta coding)
    # ------------------------------------------------------------------
    def _hot_eligible(self) -> bool:
        """May sealed updates buffer right now?  Only in a fully healthy
        cluster with no fault injection armed — every degraded, replay,
        and recovery path may read parity, so buffering pauses the
        moment a failure exists (the ``fail_server`` barrier already
        drained what was buffered before it)."""
        return (self.hot is not None and self.code.m > 0
                and not self.failed and self.crash_hook is None)

    def _hot_buffer_update(self, key: bytes, sl: StripeList, ds: int,
                           cid: ChunkId, seg_off: int,
                           seg: np.ndarray) -> bool:
        """Absorb one sealed update into the version buffer.

        Returns True when buffered — the caller then skips its parity
        round entirely (the data server already mutated in place; only
        the parity delta is deferred).  False means the key is not hot:
        take the normal per-SET parity round."""
        hot = self.hot
        entry = hot.buffer.get(key)
        if entry is not None and entry.cid != cid:
            # the key was deleted/re-SET into a different chunk since
            # buffering began — the old region's obligation flushes
            # first, then this update starts a fresh entry
            self._flush_hot_entries([hot.buffer.pop(key)], barrier=True)
            entry = None
        is_hot = hot.tracker.touch(key)
        if entry is None and not is_hot:
            return False
        entry, evicted = hot.buffer.append(key, sl, cid, seg_off, seg)
        hot.stats["buffered_updates"] += 1
        flush_now = []
        if evicted is not None:
            hot.stats["evictions"] += 1
            flush_now.append(evicted)
        if hot.buffer.full(entry):
            flush_now.append(hot.buffer.pop(key))
        if flush_now:
            self._flush_hot_entries(flush_now)
        return True

    def _hot_barrier_stripes(self, stripe_entries) -> None:
        """Read barrier: before any sealed-chunk race/decode touches a
        stripe's parity, collapse that stripe's buffered deltas back in
        (``stripe_entries``: iterable of (sl, cid))."""
        if self.hot is None or not len(self.hot.buffer):
            return
        drained = []
        for sl, cid in stripe_entries:
            drained += self.hot.buffer.pop_stripe(sl, cid)
        if drained:
            self._flush_hot_entries(drained, barrier=True)

    def _flush_hot_entries(self, entries, *, barrier: bool = False) -> float:
        """Fold buffered version deltas back into their sealed stripes.

        ONE batched ``submit_delta_collapse`` serves every entry: the
        engine XOR-collapses each key's V versions into the base→latest
        delta and folds it into the gathered parity rows — N buffered
        updates cost one parity round.  The m delta legs per key carry
        the union extent of the versions (what actually crosses the
        wire), and the whole drain is recorded as its own nested
        ``HOT_FLUSH`` request.  Applied rows use the proxy's ack
        watermark as their seq and prune immediately: a flush is acked
        by construction, so §5.3 reverts can never roll it back.
        """
        entries = [e for e in entries if e is not None and e.versions]
        if not entries:
            return 0.0
        hot = self.hot
        proxy = self.proxies[0]
        self._trace_frame()
        C = self.chunk_size
        parity = np.stack(
            [np.stack([self._sv(p).parity_row(e.sl, e.cid.stripe_id)
                       for p in e.sl.parity_servers]) for e in entries])
        positions = np.array([e.cid.position for e in entries])
        version_xors, legs = [], []
        for e in entries:
            vx = np.zeros((len(e.versions), C), np.uint8)
            for vi, (off, seg) in enumerate(e.versions):
                vx[vi, off: off + len(seg)] ^= seg
            version_xors.append(vx)
            ds = self._chunk_owner(e.sl, e.cid.position)
            lo, hi = e.extent()
            legs += [Leg("delta", hi - lo, f"s{ds}", f"s{p}",
                         self._is_failed(p))
                     for p in e.sl.parity_servers]
        fut = self.engine.submit_delta_collapse(parity, positions,
                                                version_xors)
        rows = fut.result() ^ parity
        wm = proxy.ack_watermark
        for e, erows in zip(entries, rows):
            for j, p in enumerate(e.sl.parity_servers):
                self._sv(p).apply_data_delta_row(e.sl, e.cid, erows[j],
                                                 proxy.pid, wm)
                self._sv(p).prune_deltas(proxy.pid, wm)
            m = len(e.sl.parity_servers)
            lo, hi = e.extent()
            seg_bytes = sum(len(seg) for _, seg in e.versions)
            hot.stats["flushed_keys"] += 1
            hot.stats["flushed_versions"] += len(e.versions)
            hot.stats["saved_parity_rounds"] += len(e.versions) - 1
            hot.stats["saved_parity_bytes"] += \
                max(0, seg_bytes - (hi - lo)) * m
        hot.stats["flushes"] += 1
        if barrier:
            hot.stats["barrier_flushes"] += 1
        t = self._merge_coding(self._coding_s(fut), self.net.phase(legs),
                               kind="delta")
        self.net.record("HOT_FLUSH", t)
        return t

    def flush_hot_buffers(self) -> int:
        """Drain the hot-key version buffer entirely (cooling/eviction
        happen organically; this is the explicit barrier for tests,
        benches, and shutdown).  Returns the number of entries folded."""
        if self.hot is None:
            return 0
        entries = self.hot.buffer.pop_all()
        self._flush_hot_entries(entries)
        return len(entries)

    def _mutate_small(self, kind: str, key: bytes, value: bytes | None,
                      proxy_id: int) -> bool:
        proxy = self.proxies[proxy_id]
        sl, ds = self.mapper.data_server_for(key)
        involved = [ds] + list(sl.parity_servers)
        if any(self._degraded_active(s) and self._is_failed(s) for s in involved):
            return self._degraded_mutate(kind, proxy, sl, ds, key, value)
        self._trace_frame()
        req = proxy.begin(kind.upper(), key, value, sl, ds)
        t = self.net.phase([Leg(kind, len(key) + (len(value) if value else 0),
                                f"p{proxy.pid}", f"s{ds}", self._is_failed(ds))])
        srv = self._sv(ds)
        if kind == "update":
            res = srv.update_value(key, value)
        else:
            res = srv.delete_object(key)
        if res is None:
            proxy.ack(req.seq)
            self.net.record(kind.upper(), t)
            return False
        cid, sealed, off, xor = res
        # trim the xor to its nonzero extent (what crosses the wire)
        nz = np.nonzero(xor)[0]
        if len(nz):
            seg_off, seg = off + int(nz[0]), xor[int(nz[0]): int(nz[-1]) + 1]
        else:
            seg_off, seg = off, xor[:0]
        crash = (self.crash_hook is not None and self.crash_hook[0] == kind
                 and self.crash_hook[1] == key)
        if (kind == "update" and sealed and self._hot_eligible()
                and self._hot_buffer_update(key, sl, ds, cid, seg_off,
                                            seg)):
            # hot key: the version delta is buffered and the parity
            # round deferred to the flush — ack and return with only
            # the request/ack legs on this UPDATE's clock
            t += self.net.phase([Leg("update_ack", 8, f"s{ds}",
                                     f"p{proxy.pid}",
                                     self._is_failed(ds))])
            proxy.ack(req.seq)
            self.net.record(kind.upper(), t)
            return True
        # one submitted engine call serves every parity server (fused
        # delta+apply over the gathered parity rows); resolution is safe
        # before the crash check — engine calls carry no cluster state,
        # and the per-row deltas extracted here feed the per-leg applies
        fut = None
        rows = None
        if sealed and self.code.m > 0:
            full = np.zeros(self.chunk_size, np.uint8)
            full[seg_off: seg_off + len(seg)] = seg
            old_par = np.stack([self._sv(p).parity_row(sl, cid.stripe_id)
                                for p in sl.parity_servers])
            fut = self.engine.submit_apply_delta(
                old_par[None], np.array([cid.position]), full[None])
            rows = fut.result()[0] ^ old_par
        applied = 0
        legs = []
        for j, p in enumerate(sl.parity_servers):
            if crash and applied >= self.crash_hook[2]:
                self.crash_hook = None
                raise PartialFailure(f"data server {ds} crashed after "
                                     f"{applied} parity legs")
            psrv = self._sv(p)
            if sealed:
                legs.append(Leg("delta", len(seg), f"s{ds}", f"s{p}",
                                self._is_failed(p)))
                psrv.apply_data_delta_row(sl, cid, rows[j], proxy.pid,
                                          req.seq)
            else:
                nv = value if kind == "update" else b""
                legs.append(Leg("replica_delta", len(key) + len(nv),
                                f"s{ds}", f"s{p}", self._is_failed(p)))
                psrv.apply_replica_delta(key, nv, kind == "delete",
                                         proxy.pid, req.seq)
            applied += 1
        t += self._merge_coding(self._coding_s(fut), self.net.phase(legs),
                                kind="delta")
        t += self.net.phase([Leg(f"{kind}_ack", 8, f"s{ds}", f"p{proxy.pid}",
                                 self._is_failed(ds))])
        proxy.ack(req.seq)
        # parity servers prune delta buffers using the ack watermark (§5.3)
        for p in sl.parity_servers:
            self._sv(p).prune_deltas(proxy.pid, proxy.ack_watermark)
        self.net.record(kind.upper(), t)
        return True

    def _update_small(self, key: bytes, value: bytes, proxy_id: int) -> bool:
        return self._mutate_small("update", key, value, proxy_id)

    def _delete_small(self, key: bytes, proxy_id: int) -> bool:
        return self._mutate_small("delete", key, None, proxy_id)

    def _update_large(self, key: bytes, value: bytes, proxy_id: int) -> bool:
        frags = split_fragments(key, value, self.chunk_size)
        ok = True
        for fkey, fval in frags:
            ok &= self._update_small(fkey, fval, proxy_id)
        return ok

    def _delete_large(self, key: bytes, head: bytes, proxy_id: int) -> bool:
        total = large_total(head)
        nfrag = fragment_count(total, len(key), self.chunk_size)
        for i in range(nfrag):
            self._delete_small(key + struct.pack("<I", i), proxy_id)
        return self._delete_small(key, proxy_id)

    # ------------------------------------------------------------------
    # degraded requests (§5.4) — all coordinated
    # ------------------------------------------------------------------
    def _coord_hop(self, proxy: Proxy, nbytes: int) -> float:
        return self.net.phase([Leg("coord", nbytes, f"p{proxy.pid}", "coord")])

    def _degraded_set(self, proxy: Proxy, sl: StripeList, ds: int,
                      key: bytes, value: bytes) -> bool:
        if not self._is_failed(ds):
            ref = self._sv(ds).lookup(key)
            if ref is not None:
                # upsert while a parity server is down: a key must never
                # occupy two chunk slots (module doc), so route through the
                # degraded mutate path exactly as _set_small does normally
                if ref.value_size == len(value):
                    return self._degraded_mutate("update", proxy, sl, ds,
                                                 key, value)
                self._degraded_mutate("delete", proxy, sl, ds, key, None)
        self._trace_frame()
        self._stats["degraded_requests"] += 1
        t = self._coord_hop(proxy, len(key))
        obj_bytes = object_size(len(key), len(value))
        if self._is_failed(ds):
            r = self.coordinator.redirected_server(sl, ds)
            rs = self._rs(r)
            t += self.net.phase([Leg("set_redirect", obj_bytes,
                                     f"p{proxy.pid}", f"s{r}")])
            rs.temp_objects[key] = value
            rs.temp_deletes.discard(key)
        else:
            # data server alive; some parity failed — write normally to the
            # working set, shadow-replicate to the redirected server
            legs = [Leg("set", obj_bytes, f"p{proxy.pid}", f"s{ds}")]
            cid, off, seal_events = self._sv(ds).set_object(sl, key, value)
            iseq = self._sv(ds).live_iseq(key)
            for p in sl.parity_servers:
                if self._is_failed(p):
                    r = self.coordinator.redirected_server(sl, p)
                    self._rs(r).temp_replicas[key] = (value, False, iseq)
                    legs.append(Leg("set_replica", obj_bytes,
                                    f"p{proxy.pid}", f"s{r}"))
                else:
                    self._sv(p).store_replica(key, value, iseq=iseq)
                    legs.append(Leg("set_replica", obj_bytes,
                                    f"p{proxy.pid}", f"s{p}"))
            t += self.net.phase(legs)
            t += self._handle_seals(sl, ds, seal_events)
            proxy.buffer_mapping(ds, key, cid, iseq)
        self.net.record("SET_DEG", t)
        return True

    def _best_data_chunk(self, sl: StripeList, stripe_id: int, i: int
                         ) -> tuple[np.ndarray | None, int]:
        """Best-known bytes of data chunk ``i`` of a stripe (or None if it
        never sealed), plus the server that actually serves them.  A
        failed owner's reconstructed copy at its redirected server wins
        over the owner's frozen memory — the recon chunk carries
        degraded-mode updates the memory never saw."""
        owner = sl.data_servers[i]
        cid = self._stripe_chunk_id(sl, stripe_id, i)
        if self._is_failed(owner) and self._degraded_active(owner):
            r = self.coordinator.redirected_server(sl, owner)
            rc = self._rs(r).recon.get(cid.key())
            if rc is not None:
                return rc.buf, r
        return self._sv(owner).get_sealed_chunk(cid), owner

    def _gather_available(self, sl: StripeList, stripe_id: int, position: int,
                          r: int) -> tuple[dict[int, np.ndarray], list[Leg]]:
        """Collect the surviving stripe chunks needed to reconstruct
        ``position`` at redirected server ``r`` (sealed-or-zero semantics;
        shared by on-demand and batched recovery)."""
        available: dict[int, np.ndarray] = {}
        legs = []
        # data positions: sealed-or-zero on working servers
        for i in range(self.k):
            owner = sl.data_servers[i]
            if self._is_failed(owner) or i == position:
                continue
            c = self._sv(owner).get_sealed_chunk(
                self._stripe_chunk_id(sl, stripe_id, i))
            available[i] = c if c is not None else np.zeros(self.chunk_size, np.uint8)
            legs.append(Leg("recon_fetch", self.chunk_size, f"s{owner}", f"s{r}"))
        # parity positions
        for j in range(self.n - self.k):
            owner = sl.parity_servers[j]
            pos = self.k + j
            if self._is_failed(owner) or pos == position:
                continue
            c = self._sv(owner).get_sealed_chunk(
                self._stripe_chunk_id(sl, stripe_id, pos))
            if c is not None:
                available[pos] = c
                legs.append(Leg("recon_fetch", self.chunk_size, f"s{owner}", f"s{r}"))
            elif len(available) < self.k:
                # parity never materialized => no seal happened => zero
                available[pos] = np.zeros(self.chunk_size, np.uint8)
                legs.append(Leg("recon_fetch", self.chunk_size, f"s{owner}", f"s{r}"))
        return available, legs

    def _ensure_recon(self, sl: StripeList, failed_sid: int, position: int,
                      stripe_id: int, r: int) -> tuple[ReconChunk, float]:
        """On-demand chunk reconstruction at the redirected server (§5.4).
        After `fail_server`'s batched recovery this is normally a cache hit
        (only chunks sealed *after* the failure still decode here)."""
        rs = self._rs(r)
        cid = self._stripe_chunk_id(sl, stripe_id, position)
        rc = rs.recon.get(cid.key())
        if rc is not None:
            self._stats["recon_chunk_hits"] += 1
            return rc, 0.0
        available, legs = self._gather_available(sl, stripe_id, position, r)
        # plan/execute decode: jax/pallas dispatch the pattern-group
        # matmul on-device HERE, then the fetch legs are modeled while
        # the device works (async merges the two as max)
        fut = self.engine.submit_decode([available], [[position]],
                                        self.chunk_size)
        net_t = self.net.phase(legs[: self.k]) if legs else 0.0
        t = self._merge_coding(self._coding_s(fut), net_t, kind="decode")
        rec = fut.result()[0]
        rc = ReconChunk(cid, np.array(rec[position], np.uint8))
        if position < self.k:
            rc.parse()
        rs.recon[cid.key()] = rc
        self._stats["reconstructions"] += 1
        return rc, t

    def _batch_recover_server(self, sid: int) -> tuple[float, int]:
        """Reconstruct every sealed chunk the failed server owned in ONE
        batched decode at its redirected servers (the paper's fast-recovery
        claim, §5.4/§5.5).  The coordinator knows the chunk inventory from
        the checkpointed key->chunk-ID mappings; the simulation reads it
        off the failed server's metadata directly."""
        if self.code.m == 0:
            return 0.0, 0   # no parity — nothing can be reconstructed
        srv = self._sv(sid)
        tasks = []
        for idx, cid in enumerate(srv.chunk_ids):
            if cid is None or not srv.sealed[idx]:
                continue
            sl = self.stripe_lists[cid.stripe_list_id]
            r = self.coordinator.redirected_server(sl, sid)
            if cid.key() in self._rs(r).recon:
                continue
            tasks.append((sl, cid, r))
        if not tasks:
            return 0.0, 0
        avail_list, wanted, all_legs = [], [], []
        for sl, cid, r in tasks:
            av, legs = self._gather_available(sl, cid.stripe_id,
                                              cid.position, r)
            avail_list.append(av)
            wanted.append([cid.position])
            all_legs.extend(legs[: self.k])
        # recovery time scales with volume: each redirected server drains
        # its chunk fetches link-serialized, redirected servers in parallel;
        # the one-shot batched decode is submitted first — on jax/pallas
        # the per-pattern matmuls dispatch on-device at submit (plan/
        # execute split) — and its modeled time overlaps the bulk fetches
        fut = self.engine.submit_decode(avail_list, wanted, self.chunk_size)
        t = self._merge_coding(self._coding_s(fut),
                               self.net.serialized_phase(all_legs),
                               kind="decode")
        recs = fut.result()
        for (sl, cid, r), rec in zip(tasks, recs):
            rc = ReconChunk(cid, np.array(rec[cid.position], np.uint8))
            if cid.position < self.k:
                rc.parse()
            self._rs(r).recon[cid.key()] = rc
        self._stats["reconstructions"] += len(tasks)
        self._stats["batch_recovered_chunks"] += len(tasks)
        return t, len(tasks)

    def _degraded_get(self, proxy: Proxy, sl: StripeList, ds: int, key: bytes):
        self._trace_frame()
        self._stats["degraded_requests"] += 1
        t = self._coord_hop(proxy, len(key))
        r = self.coordinator.redirected_server(sl, ds)
        rs = self._rs(r)
        t += self.net.phase([Leg("get_redirect", len(key), f"p{proxy.pid}", f"s{r}")])
        # 1. degraded-SET / shadowed objects
        if key in rs.temp_deletes:
            self.net.record("GET_DEG", t)
            return None
        if key in rs.temp_objects:
            v = rs.temp_objects[key]
            t += self.net.phase([Leg("get_resp", len(v), f"s{r}", f"p{proxy.pid}")])
            self.net.record("GET_DEG", t)
            return v
        # 2. locate the chunk via the recovered key->chunk-ID mappings
        cid = self.coordinator.chunk_id_for(ds, key)
        if cid is None:
            self.net.record("GET_DEG", t)
            return None
        rc = rs.recon.get(cid.key())
        if rc is None:
            # 3. unsealed chunk? fetch the replica from a working parity
            for p in sl.parity_servers:
                if self._is_failed(p):
                    continue
                rep = self._sv(p).get_replica(key)
                t += self.net.phase([Leg("replica_fetch", len(key),
                                         f"s{r}", f"s{p}")])
                if rep is not None:
                    value, deleted = rep
                    v = None if deleted else value
                    if v is not None:
                        t += self.net.phase([Leg("get_resp", len(v), f"s{r}",
                                                 f"p{proxy.pid}")])
                    self.net.record("GET_DEG", t)
                    return v
                break  # one probe is enough: replicas are on all parities
            # 4. sealed chunk: reconstruct on demand (chunk granularity)
            rc, t_rec = self._ensure_recon(sl, ds, cid.position,
                                           cid.stripe_id, r)
            t += t_rec
        else:
            self._stats["recon_chunk_hits"] += 1
        entry = (rc.objects or {}).get(key)
        if entry is None:
            self.net.record("GET_DEG", t)
            return None
        off, ksz, vsz, deleted = entry
        if deleted:
            self.net.record("GET_DEG", t)
            return None
        vo = off + 4 + ksz
        v = rc.buf[vo: vo + vsz].tobytes()
        t += self.net.phase([Leg("get_resp", len(v), f"s{r}", f"p{proxy.pid}")])
        self.net.record("GET_DEG", t)
        return v

    def _fan_redirect_deltas(self, cid: ChunkId, seg_off: int, seg,
                             redirected: list, legs: list[Leg]) -> float:
        """Delta fan-out completion for a degraded mutate of a sealed
        chunk.  ONE submitted engine call computes every parity row
        (each failed parity's redirect target consumes its row from it —
        previously one serial ``delta_batch`` per target with unmodeled
        cost); the legs are modeled while it is in flight and the
        redirected recon chunks are patched at resolution."""
        fut = None
        if redirected:
            full = np.zeros(self.chunk_size, np.uint8)
            full[seg_off: seg_off + len(seg)] = seg
            fut = self.engine.submit_delta(np.array([cid.position]),
                                           full[None])
        t = self._merge_coding(self._coding_s(fut), self.net.phase(legs),
                               kind="delta")
        if fut is not None:
            rows = fut.result()[0]
            for j, rc in redirected:
                rc.buf ^= rows[j]
                rc.dirty = True
        return t

    def _degraded_mutate(self, kind: str, proxy: Proxy, sl: StripeList,
                         ds: int, key: bytes, value: bytes | None) -> bool:
        self._trace_frame()
        self._stats["degraded_requests"] += 1
        t = self._coord_hop(proxy, len(key))
        if self._is_failed(ds):
            ok, t2 = self._degraded_mutate_failed_ds(kind, proxy, sl, ds, key, value)
            self.net.record(f"{kind.upper()}_DEG", t + t2)
            return ok
        # data server alive; failed parity server(s).
        # Reconstruct-first (§5.4): materialize every failed parity chunk
        # from the *pre-update* stripe before mutating anything, else the
        # decoded snapshot would already contain the update and the delta
        # would be double-applied.
        srv = self._sv(ds)
        ref = srv.lookup(key)
        if ref is None:
            self.net.record(f"{kind.upper()}_DEG", t)
            return False
        pre_cid = srv.chunk_id_of(ref)
        pre_iseq = srv.live_iseq(key)   # instance the shadow belongs to
        if srv.sealed[ref.chunk_local_idx]:
            for j, p in enumerate(sl.parity_servers):
                if self._is_failed(p):
                    r = self.coordinator.redirected_server(sl, p)
                    _, t_rec = self._ensure_recon(sl, p, self.k + j,
                                                  pre_cid.stripe_id, r)
                    t += t_rec
        res = srv.update_value(key, value) if kind == "update" else srv.delete_object(key)
        if res is None:
            self.net.record(f"{kind.upper()}_DEG", t)
            return False
        cid, sealed, off, xor = res
        nz = np.nonzero(xor)[0]
        seg_off = off + (int(nz[0]) if len(nz) else 0)
        seg = xor[int(nz[0]): int(nz[-1]) + 1] if len(nz) else xor[:0]
        legs = []
        redirected: list[tuple[int, ReconChunk]] = []
        for j, p in enumerate(sl.parity_servers):
            pos = self.k + j
            if not self._is_failed(p):
                if sealed:
                    self._sv(p).apply_data_delta(sl, cid, seg_off, seg,
                                                 proxy.pid, proxy.seq)
                else:
                    nv = value if kind == "update" else b""
                    self._sv(p).apply_replica_delta(key, nv, kind == "delete",
                                                    proxy.pid, proxy.seq)
                legs.append(Leg("delta", len(seg), f"s{ds}", f"s{p}"))
                continue
            # failed parity: delta goes to its redirected server (§5.4),
            # which reconstructs the parity chunk first
            r = self.coordinator.redirected_server(sl, p)
            if sealed:
                rc, t_rec = self._ensure_recon(sl, p, pos, cid.stripe_id, r)
                t += t_rec
                redirected.append((j, rc))
            else:
                # shadow must keep the value size (zero-filled) exactly
                # like apply_replica_delta does — the eventual seal
                # rebuild packs tombstones at their original extent
                nv = (value if kind == "update"
                      else b"\x00" * ref.value_size)
                self._rs(r).temp_replicas[key] = (nv, kind == "delete",
                                                  pre_iseq)
            legs.append(Leg("delta_redirect", len(seg), f"s{ds}", f"s{r}"))
        t += self._fan_redirect_deltas(cid, seg_off, seg, redirected, legs)
        self.net.record(f"{kind.upper()}_DEG", t)
        return True

    def _degraded_mutate_failed_ds(self, kind, proxy, sl, ds, key, value):
        """UPDATE/DELETE when the object's data server is down."""
        t = 0.0
        r = self.coordinator.redirected_server(sl, ds)
        rs = self._rs(r)
        # degraded-SET'd or shadowed object
        if key in rs.temp_objects:
            if kind == "update":
                rs.temp_objects[key] = value
            else:
                rs.temp_objects.pop(key, None)
                rs.temp_deletes.add(key)
            return True, t
        cid = self.coordinator.chunk_id_for(ds, key)
        if cid is None:
            return False, t
        # is the chunk sealed? probe a working parity for a replica
        probe_parity = next((p for p in sl.parity_servers
                             if not self._is_failed(p)), None)
        rep = self._sv(probe_parity).get_replica(key) if probe_parity is not None else None
        t += self.net.phase([Leg("replica_fetch", len(key), f"s{r}",
                                 f"s{probe_parity}")])
        if rep is not None:
            # unsealed object: shadow the mutation at the redirected server
            # (migrated back as a normal UPDATE/DELETE on restore)
            if kind == "update":
                rs.temp_objects[key] = value
            else:
                rs.temp_deletes.add(key)
            return True, t
        # sealed chunk: reconstruct-first (§5.4) — the data chunk AND any
        # failed parity chunks, all from the pre-update stripe — then
        # mutate and fan out deltas.
        rc, t_rec = self._ensure_recon(sl, ds, cid.position, cid.stripe_id, r)
        t += t_rec
        for j2, p2 in enumerate(sl.parity_servers):
            if self._is_failed(p2):
                r2 = self.coordinator.redirected_server(sl, p2)
                _, t_rec2 = self._ensure_recon(sl, p2, self.k + j2,
                                               cid.stripe_id, r2)
                t += t_rec2
        entry = (rc.objects or {}).get(key)
        if entry is None or entry[3]:
            return False, t
        off, ksz, vsz, _ = entry
        ext = object_size(ksz, vsz)
        old = rc.buf[off: off + ext].copy()
        if kind == "update":
            if len(value) != vsz:
                raise ValueError("value size must not change across updates")
            rc.buf[off + 4 + ksz: off + 4 + ksz + vsz] = np.frombuffer(value, np.uint8)
        else:
            vfield = vsz | (1 << 23)
            rc.buf[off + 1: off + 4] = np.frombuffer(
                struct.pack("<I", vfield)[:3], np.uint8)
            rc.buf[off + 4 + ksz: off + 4 + ksz + vsz] = 0
            rc.objects[key] = (off, ksz, vsz, True)
        rc.dirty = True
        xor = old ^ rc.buf[off: off + ext]
        nz = np.nonzero(xor)[0]
        seg_off = off + (int(nz[0]) if len(nz) else 0)
        seg = xor[int(nz[0]): int(nz[-1]) + 1] if len(nz) else xor[:0]
        legs = []
        redirected = []
        for j, p in enumerate(sl.parity_servers):
            if self._is_failed(p):
                r2 = self.coordinator.redirected_server(sl, p)
                rc2, t_rec2 = self._ensure_recon(sl, p, self.k + j,
                                                 cid.stripe_id, r2)
                t += t_rec2
                redirected.append((j, rc2))
                legs.append(Leg("delta_redirect", len(seg), f"s{r}", f"s{r2}"))
            else:
                self._sv(p).apply_data_delta(sl, cid, seg_off, seg,
                                             proxy.pid, proxy.seq)
                legs.append(Leg("delta", len(seg), f"s{r}", f"s{p}"))
        t += self._fan_redirect_deltas(cid, seg_off, seg, redirected, legs)
        return True, t

    # ------------------------------------------------------------------
    # failure / restore transitions (§5.2, §5.5)
    # ------------------------------------------------------------------
    def inflate_server(self, sid: int, factor: float):
        """Slow-server injection (the straggler axis, alongside
        fail/recover): every leg touching server ``sid`` is
        latency-inflated by ``factor``; ``factor=1.0`` restores.  The
        server keeps serving — it is slow, not failed — which is
        exactly the case degraded mode can't see and k-of-(k+Δ) reads
        mitigate."""
        self.net.inflate(f"s{sid}", factor)

    def fail_server(self, sid: int, recover: bool = True) -> dict:
        """Inject a transient failure; returns transition timings.

        ``recover=False`` skips the eager one-shot batched recovery so
        every degraded request reconstructs on demand through
        ``_ensure_recon`` — the paper's §5.4 on-demand mode, used by the
        benchmarks to expose the decode path on degraded GET latency."""
        if self.hot is not None and len(self.hot.buffer):
            # failure barrier: collapse every buffered hot-key delta
            # while the cluster is still healthy — recovery, degraded
            # decode, and replay all read parity, and buffering stays
            # paused until the failure set empties (_hot_eligible)
            self._flush_hot_entries(self.hot.buffer.pop_all(),
                                    barrier=True)
        self.failed.add(sid)
        if not self.degraded_enabled:
            return {"T_N_to_D": 0.0}
        t = 0.0
        # NORMAL -> INTERMEDIATE: atomic broadcast includes the failed
        # (congested) server — hence the higher latency the paper observes.
        self.coordinator.set_state(sid, ServerState.INTERMEDIATE)
        legs = [Leg("state_bcast", 16, "coord", f"s{s}", s in self.failed)
                for s in range(len(self.servers))]
        legs += [Leg("state_bcast", 16, "coord", f"p{p.pid}") for p in self.proxies]
        t += self.net.phase(legs)
        # resolve inconsistency: revert parity deltas of unacked requests
        replay: list[tuple[int, object]] = []
        for proxy in self.proxies:
            unacked = proxy.unacked_seqs()
            if not unacked:
                continue
            legs = []
            for srv in self.servers:
                if srv.sid in self.failed:
                    continue
                nrev = srv.revert_deltas(proxy.pid, unacked)
                if nrev:
                    self._stats["reverted_deltas"] += nrev
                    legs.append(Leg("revert", 16 * nrev, f"p{proxy.pid}",
                                    f"s{srv.sid}"))
            if legs:
                t += self.net.phase(legs)
            for seq, req in sorted(proxy.pending.items()):
                if req.data_server == sid or sid in req.stripe_list.servers:
                    replay.append((proxy.pid, req))
        # collect key->chunk-ID mapping backups from proxies (§5.3)
        proxy_maps = []
        legs = []
        for proxy in self.proxies:
            pm = proxy.mappings_for(sid)
            proxy_maps.append(pm)
            legs.append(Leg("mapping_push", sum(len(k) + 12 for k, _, _ in pm),
                            f"p{proxy.pid}", "coord"))
        t += self.net.phase(legs)
        self.coordinator.merge_proxy_mappings(sid, proxy_maps)
        # also merge the server's own mapping log that was checkpointed;
        # plus anything in its log the proxies still buffer — done above.
        # INTERMEDIATE -> DEGRADED
        self.coordinator.set_state(sid, ServerState.DEGRADED)
        legs = [Leg("state_bcast", 16, "coord", f"s{s}")
                for s in range(len(self.servers)) if s not in self.failed]
        legs += [Leg("state_bcast", 16, "coord", f"p{p.pid}") for p in self.proxies]
        t += self.net.phase(legs)
        # if sid itself hosted degraded state as a redirect target for an
        # earlier failure, hand it off to freshly assigned targets
        t += self._handoff_redirect_state(sid)
        timings = {"T_N_to_D": t}
        # fast batched recovery (§5.4): reconstruct every chunk the failed
        # server owned in one batched decode at the redirected servers,
        # so degraded requests (and the replay below) hit a warm cache.
        # Timed separately — the paper reports transition and recovery
        # durations independently.
        t_rec, n_rec = (self._batch_recover_server(sid) if recover
                        else (0.0, 0))
        timings["T_recovery"] = t_rec
        timings["recovered_chunks"] = n_rec
        # replay incomplete requests as degraded requests
        for pid, req in replay:
            self.proxies[pid].pending.pop(req.seq, None)
            self.proxies[pid].ack(req.seq)
            if req.kind == "SET":
                self._degraded_set(self.proxies[pid], req.stripe_list,
                                   req.data_server, req.key, req.value)
            elif req.kind == "UPDATE":
                self._degraded_mutate("update", self.proxies[pid],
                                      req.stripe_list, req.data_server,
                                      req.key, req.value)
            elif req.kind == "DELETE":
                self._degraded_mutate("delete", self.proxies[pid],
                                      req.stripe_list, req.data_server,
                                      req.key, None)
        return timings

    def _handoff_redirect_state(self, failing: int) -> float:
        """Graceful transition under overlapping failures (§5.2 spirit):
        when a server that is itself a redirect target fails, the degraded
        state it hosts (reconstructed chunks, degraded-SET objects, shadow
        replicas) is handed off to freshly chosen redirect targets during
        the INTERMEDIATE window, before the server goes fully dark.
        Without this, a fail(A) -> fail(redirect-of-A) interleaving would
        strand acknowledged degraded writes."""
        rs = self.redirect.get(failing)
        if rs is None:
            return 0.0
        legs = []
        moved = 0
        # 1. reconstructed chunks — owners are still-failed servers
        #    (restore_server already drained entries of restored owners)
        for key_t, rc in list(rs.recon.items()):
            del rs.recon[key_t]
            sl = self.stripe_lists[rc.chunk_id.stripe_list_id]
            owner = self._chunk_owner(sl, rc.chunk_id.position)
            if not self._is_failed(owner):
                continue  # stale entry; owner's memory is authoritative
            r2 = self.coordinator.redirected_server(sl, owner)
            self._rs(r2).recon[key_t] = rc
            legs.append(Leg("handoff_chunk", self.chunk_size,
                            f"s{failing}", f"s{r2}"))
            moved += 1
        # 2. degraded-SET objects and shadowed deletes
        for okey in list(rs.temp_objects):
            val = rs.temp_objects.pop(okey)
            sl2, ds2 = self.mapper.data_server_for(okey)
            if self._is_failed(ds2):
                r2 = self.coordinator.redirected_server(sl2, ds2)
                self._rs(r2).temp_objects[okey] = val
                self._rs(r2).temp_deletes.discard(okey)
                legs.append(Leg("handoff_obj", len(okey) + len(val),
                                f"s{failing}", f"s{r2}"))
                moved += 1
            else:  # owner back already: land it as a normal request
                self.set(okey, val, 0)
        for okey in list(rs.temp_deletes):
            rs.temp_deletes.discard(okey)
            sl2, ds2 = self.mapper.data_server_for(okey)
            if self._is_failed(ds2):
                r2 = self.coordinator.redirected_server(sl2, ds2)
                self._rs(r2).temp_deletes.add(okey)
                self._rs(r2).temp_objects.pop(okey, None)
                moved += 1
            else:
                self.delete(okey, 0)
        # 3. shadow replicas for failed parity servers (one copy per
        # distinct redirect target still covering a failed parity)
        for okey, rep in list(rs.temp_replicas.items()):
            del rs.temp_replicas[okey]
            sl2, _ = self.mapper.data_server_for(okey)
            targets = {self.coordinator.redirected_server(sl2, p)
                       for p in sl2.parity_servers if self._is_failed(p)}
            for r2 in sorted(targets):
                self._rs(r2).temp_replicas[okey] = rep
                legs.append(Leg("handoff_replica", len(okey) + len(rep[0]),
                                f"s{failing}", f"s{r2}"))
                moved += 1
        self._stats["redirect_handoffs"] += moved
        return self.net.phase(legs) if legs else 0.0

    def restore_server(self, sid: int) -> dict:
        """Restore a transiently-failed server (§5.5): migrate, then NORMAL."""
        if sid not in self.failed:
            return {"T_D_to_N": 0.0}
        t = 0.0
        if not self.degraded_enabled:
            self.failed.discard(sid)
            return {"T_D_to_N": 0.0}
        self.coordinator.set_state(sid, ServerState.COORDINATED_NORMAL)
        legs = [Leg("state_bcast", 16, "coord", f"s{s}")
                for s in range(len(self.servers))]
        legs += [Leg("state_bcast", 16, "coord", f"p{p.pid}") for p in self.proxies]
        t += self.net.phase(legs)
        self.failed.discard(sid)
        restored = self._sv(sid)
        # --- migration from every redirected server ---
        for r, rs in list(self.redirect.items()):
            legs = []
            # 1. dirty reconstructed chunks owned by sid
            for key_t, rc in list(rs.recon.items()):
                sl = self.stripe_lists[rc.chunk_id.stripe_list_id]
                owner = self._chunk_owner(sl, rc.chunk_id.position)
                if owner != sid:
                    continue
                if rc.dirty:
                    slot = restored.slot_of_chunk(rc.chunk_id)
                    if slot is None:
                        slot = restored._alloc_slot(rc.chunk_id)
                        restored.sealed[slot] = True
                    restored.region[slot][:] = rc.buf
                    legs.append(Leg("migrate_chunk", self.chunk_size,
                                    f"s{r}", f"s{sid}"))
                    self._stats["migrated_chunks"] += 1
                    if rc.chunk_id.position < self.k:
                        # fix the object index for objects deleted in
                        # degraded mode — only when the index still points
                        # at THIS slot: a tombstone that predates the
                        # failure may coexist with a live re-SET instance
                        # of the same key in another chunk (delete-then-
                        # re-add churn, e.g. migrate-out/migrate-back)
                        for okey, (off, ksz, vsz, deleted) in (rc.objects or {}).items():
                            if not deleted:
                                continue
                            ref = restored.lookup(okey)
                            if (ref is not None
                                    and ref.chunk_local_idx == slot
                                    and ref.offset == off):
                                restored.object_index.delete(okey)
                del rs.recon[key_t]
            # 2. degraded-SET objects + shadowed mutations routed to sid
            for okey in list(rs.temp_objects.keys()):
                sl2, ds2 = self.mapper.data_server_for(okey)
                if ds2 != sid:
                    continue
                val = rs.temp_objects.pop(okey)
                legs.append(Leg("migrate_obj", len(okey) + len(val),
                                f"s{r}", f"s{sid}"))
                self._stats["migrated_objects"] += 1
                ref = restored.lookup(okey)
                if ref is not None and ref.value_size == len(val):
                    self._update_small(okey, val, 0)
                else:
                    if ref is not None:
                        self._delete_small(okey, 0)
                    self._set_small(okey, val, 0)
            for okey in list(rs.temp_deletes):
                sl2, ds2 = self.mapper.data_server_for(okey)
                if ds2 != sid:
                    continue
                rs.temp_deletes.discard(okey)
                if restored.lookup(okey) is not None:
                    self._delete_small(okey, 0)
            # 3. shadow replicas destined to sid (it was a parity server).
            # One shadow entry serves every failed parity of the list that
            # redirected here, so migrate a COPY and only drop the entry
            # once no parity of the list remains failed.
            for okey, (val, deleted, siseq) in list(rs.temp_replicas.items()):
                sl2, _ = self.mapper.data_server_for(okey)
                if sid not in sl2.parity_servers:
                    continue
                old = restored.temp_replicas.get(okey)
                old_iseq = restored.replica_iseq.get(okey)
                if (old is not None and old_iseq is not None
                        and old_iseq != siseq):
                    # the shadow belongs to a NEWER instance: the one this
                    # parity still holds was deleted during the outage (a
                    # key is only re-added after delete), so park its
                    # final tombstone state for that chunk's future seal
                    restored.zombie_replicas[(okey, old_iseq)] = \
                        (b"\x00" * len(old[0]), True)
                restored.temp_replicas[okey] = (val, deleted)
                if siseq is None:
                    restored.replica_iseq.pop(okey, None)
                else:
                    restored.replica_iseq[okey] = siseq
                legs.append(Leg("migrate_replica", len(okey) + len(val),
                                f"s{r}", f"s{sid}"))
                if not any(self._is_failed(p) for p in sl2.parity_servers):
                    del rs.temp_replicas[okey]
            if legs:
                t += self.net.phase(legs)
        # 4. heal replica invariants: re-replicate sid's unsealed objects
        legs = []
        for lid, ucs in restored.unsealed.items():
            sl = self.stripe_lists[lid]
            for uc in ucs:
                for okey, off in uc.builder.objects:
                    ref = restored.lookup(okey)
                    if ref is None or ref.chunk_local_idx != uc.local_idx \
                            or ref.offset != off:
                        continue  # superseded copy
                    val = restored.get_value(okey)
                    iseq = restored.live_iseq(okey)
                    for p in sl.parity_servers:
                        self._sv(p).store_replica(okey, val, iseq=iseq)
                        legs.append(Leg("rereplicate", len(okey) + len(val),
                                        f"s{sid}", f"s{p}"))
        if legs:
            t += self.net.phase(legs)
        # 5. GC stale replicas: chunks that sealed while sid was down never
        # popped sid's replicas; a stale replica would shadow post-seal
        # updates on a future degraded read.
        self._gc_stale_replicas(sid)
        # drop sticky degraded-routing assignments for the restored server
        self.coordinator.clear_redirects(sid)
        # COORDINATED_NORMAL -> NORMAL
        self.coordinator.set_state(sid, ServerState.NORMAL)
        legs = [Leg("state_bcast", 16, "coord", f"s{s}")
                for s in range(len(self.servers))]
        legs += [Leg("state_bcast", 16, "coord", f"p{p.pid}") for p in self.proxies]
        t += self.net.phase(legs)
        return {"T_D_to_N": t}

    def _gc_stale_replicas(self, sid: int):
        srv = self._sv(sid)
        for key in list(srv.temp_replicas.keys()):
            sl, ds = self.mapper.data_server_for(key)
            if sid not in sl.parity_servers:
                del srv.temp_replicas[key]
                srv.replica_iseq.pop(key, None)
                continue
            dsrv = self._sv(ds)
            ref = dsrv.lookup(key)
            if ref is not None and dsrv.sealed[ref.chunk_local_idx]:
                del srv.temp_replicas[key]
                srv.replica_iseq.pop(key, None)
            # ref is None (deleted object): keep the tombstoned replica —
            # it reads as None either way and may still be needed for a
            # pending seal rebuild.

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def resident_keys(self) -> list[bytes]:
        """Every key this shard currently answers for, sorted (stable
        across runs).  Covers the data servers' object indexes plus
        degraded-mode state parked at redirected servers (degraded-SET
        objects that no server index has seen yet).  Used by the
        migration planner; includes large-object fragment/manifest keys —
        the planner filters fragments itself."""
        out: set[bytes] = set()
        for srv in self.servers:
            out.update(srv.object_index.keys())
        for rs in self.redirect.values():
            out.update(rs.temp_objects.keys())
        return sorted(out)

    def total_memory(self) -> dict:
        agg: dict[str, int] = {}
        for s in self.servers:
            for k, v in s.memory_bytes().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def stored_payload_bytes(self) -> int:
        return sum(s.bytes_stored for s in self.servers)
