"""Sharded MemEC: hash-partitioned shard stores, pipelined cross-shard batches.

Scaling seam on top of the unsharded cluster (ROADMAP: "sharded stores
driving per-shard engines").  A ``ShardedCluster`` partitions the key space
(FNV-1a hash of key -> shard) across S independent ``MemECCluster`` shard
stores.  Each shard owns its own stripe lists, servers, proxies,
coordinator state, netsim accounting, and ``CodingEngine`` instance —
mixed backends per shard are allowed (e.g. ``engine="pallas,numpy"`` puts
Pallas on hot shards and numpy elsewhere; see ``engine_specs``).

Batched multi-key requests go through a cross-shard scatter/gather
planner: keys are grouped per shard in request order, the per-shard
engine+network batches execute concurrently (one worker per shard — real
wall-clock overlap of coding with other shards' in-flight netsim legs,
the ROADMAP's async seam), and results merge back in request order.  The
merged request's modeled latency is the *slowest shard's* batch time
(full pipeline overlap across disjoint shard hardware); the facade tracks
how much modeled time the overlap saved versus sequential shard execution
(``stats["pipeline_overlap_saved_s"]``).

Failures are shard-scoped: ``fail_server``/``restore_server`` take a
global server id (``shard * servers_per_shard + local``) or an explicit
``shard=`` kwarg, and recovery of one shard never blocks traffic on the
others — non-failed shards keep serving decentralized normal-mode
requests throughout.

Key routing goes through a pluggable ``Placement`` policy (core/ring.py):
the historical FNV-1a-mod map (default, ``placement="mod"``) or a
consistent-hash ring with virtual nodes and weights (``"ring"`` /
``$MEMEC_PLACEMENT``).  With a ring the cluster is *elastic*:
``add_shard``/``remove_shard`` grow or drain membership and
``rebalance()`` escapes load skew, all executing live stripe migrations
through ``core/rebalance.py`` — a forwarding table (``_pending``) keeps
every key readable and writable mid-migration, and per-shard load
counters (``shard_ops``/``load_skew``) feed both the skew decisions and
``stats()``/``net.snapshot()``.

The unsharded cluster is the S=1 special case: ``make_cluster`` returns a
plain ``MemECCluster`` for one shard, so every existing call site keeps
working; ``shards=`` / ``$MEMEC_SHARDS`` opt in to S>1.
"""
from __future__ import annotations

import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

from .index import fnv1a
from .netsim import LatencyRecorder, NetSim, resolve_arrival
from .ring import make_placement
from .store import MemECCluster
from .trace import Span, _fill_seq, resolve_trace

# dedicated hash seed: shard routing must stay independent of the
# per-shard two-stage stripe hashing (stripe.py)
SHARD_SEED = 0x01000193

# batch request kinds the facade re-records with pipelined latencies;
# the per-shard components are excluded from aggregate latency views
BATCH_KINDS = ("MGET", "MSET", "MUPDATE")


def shard_for_key(key: bytes, num_shards: int) -> int:
    """The historical FNV-1a-mod partition (``ModPlacement``'s formula).

    Kept as the mod-policy primitive; cluster code must route through
    ``ShardedCluster.shard_of`` / a ``Placement`` (core/ring.py) instead
    of calling this directly, so elastic placements stay pluggable."""
    if num_shards <= 1:
        return 0
    return fnv1a(key, seed=SHARD_SEED) % num_shards


def resolve_shards(shards=None) -> int:
    """Shard count from the argument or ``$MEMEC_SHARDS`` (default 1)."""
    if shards is None:
        shards = os.environ.get("MEMEC_SHARDS")
    s = 1 if shards in (None, "") else int(shards)
    if s < 1:
        raise ValueError(f"shards must be >= 1, got {s}")
    return s


class ShardedNet:
    """NetSim-shaped aggregate view over per-shard netsims.

    Byte/message counters come from the shards; request latencies come
    from the facade's own records in ``local`` — every routed request,
    single-key and batched, is recorded there (per-shard records are
    that request's shard slice, not an independent client request).
    Endpoints are namespaced ``sh{i}:s{j}`` for S>1 (each shard is
    separate hardware) and left bare for S=1 so the view is a drop-in
    for the unsharded net.
    """

    def __init__(self, cluster: "ShardedCluster"):
        self._cl = cluster
        # the facade's own event runtime lives here: merged batches and
        # migration legs are submitted against per-shard "sh{i}" resource
        # clocks (shard nets stay closed-loop — their phase algebra is
        # the service time, the facade adds the queueing)
        self.local = NetSim(cluster.shards[0].net.cost,
                            arrival=cluster.arrival,
                            trace=cluster._facade_tracer or False)
        self.cost = self.local.cost

    @property
    def events(self):
        return self.local.events

    @property
    def arrival(self):
        return self.local.arrival

    def _shard_nets(self):
        return [sh.net for sh in self._cl.shards]

    def _prefix(self, i: int, ep: str) -> str:
        return ep if self._cl.num_shards == 1 else f"sh{i}:{ep}"

    # -- recording (facade-level merged batches) ------------------------
    def record(self, req_kind: str, latency_s: float):
        self.local.record(req_kind, latency_s)

    # -- merged views ----------------------------------------------------
    @property
    def latencies(self) -> dict:
        """Client-request latencies.  Every facade-routed request —
        single-key (since PR 8) and batched — records here; shard-level
        records are either subsumed by a facade record (the per-shard
        slice of a routed request) or shard-internal control-plane
        traffic (degraded replays inside fail/restore), still visible on
        ``shards[i].net.latencies``."""
        return {k: xs for k, xs in self.local.latencies.items() if xs}

    @property
    def ops_by_kind(self) -> dict:
        return {k: n for k, n in self.local.ops_by_kind.items() if n}

    @property
    def bytes_by_kind(self) -> dict:
        out = defaultdict(int)
        for net in self._shard_nets():
            for kind, n in net.bytes_by_kind.items():
                out[kind] += n
        for kind, n in self.local.bytes_by_kind.items():
            out[kind] += n      # facade-level traffic (stripe migration)
        return dict(out)

    @property
    def msgs_by_kind(self) -> dict:
        out = defaultdict(int)
        for net in self._shard_nets():
            for kind, n in net.msgs_by_kind.items():
                out[kind] += n
        for kind, n in self.local.msgs_by_kind.items():
            out[kind] += n
        return dict(out)

    @property
    def bytes_by_endpoint(self) -> dict:
        out = {}
        for i, net in enumerate(self._shard_nets()):
            for ep, n in net.bytes_by_endpoint.items():
                out[self._prefix(i, ep)] = n
        for ep, n in self.local.bytes_by_endpoint.items():
            # facade legs carry pre-namespaced endpoints (sh{i}:..., mig)
            out[ep] = out.get(ep, 0) + n
        return out

    # -- reporting (shared LatencyRecorder formulas — cannot diverge
    # from NetSim's) ----------------------------------------------------
    def percentile(self, req_kind: str, q: float) -> float:
        return LatencyRecorder.percentile_of(
            self.latencies.get(req_kind, []), q)

    def mean(self, req_kind: str) -> float:
        return LatencyRecorder.mean_of(self.latencies.get(req_kind, []))

    def latency_summary(self) -> dict:
        """Per-kind count/mean/p50/p99/p999 over the merged view (same
        shape as ``NetSim.latency_summary``), with facade-level queue
        waits attached in event mode."""
        out = {k: LatencyRecorder.summary_of(xs)
               for k, xs in sorted(self.latencies.items())}
        if self.local.events is not None:
            for kind, s in out.items():
                ws = self.local.events.waits.latencies.get(kind, [])
                s["queue_wait_s"] = sum(ws)
                s["queue_wait_p99_s"] = LatencyRecorder.percentile_of(ws, 99.0)
        return out

    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def _endpoint_pool(self, endpoints):
        pool = self.bytes_by_endpoint
        if endpoints is not None:
            pool = {e: pool.get(e, 0) for e in endpoints}
        return pool

    def bottleneck_throughput(self, total_ops: int,
                              endpoints: list[str] | None = None) -> float:
        pool = self._endpoint_pool(endpoints)
        if not pool or total_ops == 0:
            return float("nan")
        worst = max(pool.values())
        if worst == 0:
            return float("inf")
        return total_ops / (worst / self.cost.bw_Bps)

    def mean_throughput(self, total_ops: int,
                        endpoints: list[str] | None = None) -> float:
        pool = self._endpoint_pool(endpoints)
        if not pool or total_ops == 0:
            return float("nan")
        total = sum(pool.values())
        if total == 0:
            return float("inf")
        return total_ops / (total / (len(pool) * self.cost.bw_Bps))

    def reset(self):
        for net in self._shard_nets():
            net.reset()
        self.local.reset()

    def snapshot(self) -> dict:
        # per-shard load + skew ride along so rebalancing decisions and
        # benchmarks read one source of truth
        out = {
            "bytes_by_kind": self.bytes_by_kind,
            "msgs_by_kind": self.msgs_by_kind,
            "bytes_by_endpoint": self.bytes_by_endpoint,
            "shard_ops": list(self._cl.shard_ops),
            "load_skew": self._cl.load_skew(),
        }
        if self.local.events is not None:
            out["event"] = self.local.events.snapshot()
        return out


class ShardedCluster:
    """Facade over S independent ``MemECCluster`` shard stores.

    Exposes the full cluster request API (single-key + multi-key), with
    multi-key requests planned across shards and pipelined.  Constructor
    keywords other than ``shards``/``engine``/``pipeline`` are forwarded
    verbatim to every shard store.
    """

    def __init__(self, shards=None, engine=None, pipeline: bool = True,
                 placement=None, arrival=None, trace=None, **cluster_kw):
        from .engine import engine_specs
        self.num_shards = resolve_shards(shards)
        self._engine_spec = engine
        # open-loop event mode runs at the facade (ShardedNet.local): the
        # shard stores are forced closed-loop so their phase algebra
        # stays the pure per-shard service time — the facade adds the
        # queueing against per-shard resource clocks.
        self.arrival = resolve_arrival(arrival)
        # span tracing mirrors that split: the facade tracer records the
        # client-visible requests; each shard gets its own tracer whose
        # request roots are grafted into the facade spans per shard slice
        self._facade_tracer = resolve_trace(trace)
        self._cluster_kw = dict(cluster_kw, arrival="closed",
                                trace=self._facade_tracer is not None)
        specs = engine_specs(engine, self.num_shards)
        self.shards = [MemECCluster(engine=specs[i], shard_id=i,
                                    **self._cluster_kw)
                       for i in range(self.num_shards)]
        s0 = self.shards[0]
        self.servers_per_shard = len(s0.servers)
        self.num_proxies = s0.num_proxies
        self.code, self.n, self.k = s0.code, s0.n, s0.k
        self.chunk_size = s0.chunk_size
        self.degraded_enabled = s0.degraded_enabled
        # intra-shard async pipeline (PR 4) — the per-shard stores resolve
        # the knob ($MEMEC_ASYNC / async_engine= in cluster_kw); exposed
        # here so drivers can pick proxy-spread batches (`proxy_id=None`)
        self.async_engine = s0.async_engine
        # straggler-tolerant read knob (resolved per shard store from
        # redundant_reads= in cluster_kw / $MEMEC_REDUNDANT_READS)
        self.redundant_reads = s0.redundant_reads
        self.engines = [sh.engine for sh in self.shards]
        self.engine = self.engines[0]
        self.pipeline = bool(pipeline) and self.num_shards > 1
        self._stats = {"cross_shard_batches": 0, "pipelined_batches": 0,
                       "pipeline_overlap_saved_s": 0.0,
                       "migrations": 0, "migrated_keys": 0,
                       "migration_bytes": 0, "migration_chunk_bytes": 0}
        # elastic placement: all key routing flows through the Placement
        # policy (core/ring.py); retired shard ids leave the policy but
        # keep their (drained) stores so global server ids stay stable
        self.placement = make_placement(placement, self.num_shards)
        self.retired: set[int] = set()
        # forwarding table for live migration: key -> shard that still
        # holds its bytes (supersedes the placement until the move lands)
        self._pending: dict[bytes, int] = {}
        # per-shard request counters (facade-routed ops) feeding the
        # load-skew metric and skew-aware rebalancing
        self.shard_ops: list[int] = [0] * self.num_shards
        self.net = ShardedNet(self)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def shard_of(self, key: bytes) -> int:
        if self._pending:
            si = self._pending.get(key)
            if si is not None:
                return si
        return self.placement.shard_for(key)

    def _shard_for(self, key: bytes) -> MemECCluster:
        si = self.shard_of(key)
        self.shard_ops[si] += 1
        return self.shards[si]

    def locate(self, key: bytes):
        """(shard id, stripe list, data server) for a key."""
        si = self.shard_of(key)
        sl, ds = self.shards[si].mapper.data_server_for(key)
        return si, sl, ds

    def global_sid(self, shard: int, local_sid: int) -> int:
        return shard * self.servers_per_shard + local_sid

    def _resolve_server(self, sid: int, shard: int | None) -> tuple[int, int]:
        if shard is None:
            shard, sid = divmod(sid, self.servers_per_shard)
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"no shard {shard}")
        return shard, sid

    @property
    def failed(self) -> set[int]:
        """Global ids of every transiently-failed server across shards."""
        return {self.global_sid(i, s)
                for i, sh in enumerate(self.shards) for s in sh.failed}

    @property
    def stats(self) -> dict:
        out = dict(self._stats)
        for sh in self.shards:
            for k, v in sh.stats.items():
                if not isinstance(v, (int, float)):
                    continue  # nested summaries are rebuilt facade-level
                out[k] = out.get(k, 0) + v
        hot = [sh.stats["hot_tier"] for sh in self.shards
               if "hot_tier" in sh.stats]
        if hot:
            # nested hot-tier summaries are skipped by the numeric merge
            # above — rebuild them facade-level (counter-wise sum)
            merged: dict = {}
            for h in hot:
                for k, v in h.items():
                    merged[k] = merged.get(k, 0) + v
            out["hot_tier"] = merged
        out["shard_ops"] = list(self.shard_ops)
        out["load_skew"] = self.load_skew()
        # merged-view latency percentiles (shared LatencyRecorder
        # formulas) + facade queue-wait breakdown in event mode
        out["latency"] = self.net.latency_summary()
        if self.net.events is not None:
            ev = self.net.events.snapshot()
            out["arrival"] = ev["arrival"]
            out["queue_wait_s"] = ev["queue_wait_s"]
            out["queue_wait_s_by_kind"] = ev["queue_wait_s_by_kind"]
            out["queue_wait_s_by_resource"] = ev["queue_wait_s_by_resource"]
            out["event_makespan_s"] = ev["makespan_s"]
        return out

    def load_skew(self) -> float:
        """Max/mean facade-routed ops across *active* shards (1.0 =
        perfectly balanced; the metric skew-aware rebalancing watches)."""
        loads = [self.shard_ops[s] for s in self.placement.shard_ids
                 if s < len(self.shard_ops)]
        total = sum(loads)
        if not loads or total == 0:
            return 1.0
        return max(loads) / (total / len(loads))

    def reset_load(self):
        """Zero the per-shard op counters (start a fresh skew window)."""
        self.shard_ops = [0] * len(self.shards)

    def server_endpoint_names(self) -> list[str]:
        return [self.net._prefix(i, ep)
                for i, sh in enumerate(self.shards)
                for ep in sh.server_endpoint_names()]

    @property
    def tracer(self):
        """The facade span tracer (None when tracing is off)."""
        return self.net.local.tracer

    def _shard_window(self, sh):
        """Start-of-request snapshot of one shard's recorded time,
        tracer position, and degraded counter."""
        str_ = sh.tracer
        return (sh.net.total_recorded_s,
                len(str_.requests) if str_ is not None else 0,
                sh._stats["degraded_requests"])

    def _shard_slice(self, sh, window):
        """Close a window: (modeled seconds, grafted shard request spans
        — moved out of the shard tracer, degraded?)."""
        t0, n0, d0 = window
        spans = None
        if sh.tracer is not None:
            spans = sh.tracer.requests[n0:]
            del sh.tracer.requests[n0:]
        return (sh.net.total_recorded_s - t0, spans,
                sh._stats["degraded_requests"] > d0)

    # ------------------------------------------------------------------
    # single-key API — shard-local execution, facade-level recording:
    # each op is one facade request (one event in open-loop mode, one
    # span tree when tracing), closing the ROADMAP gap where sharded
    # single-key traffic bypassed the facade EventRuntime.
    # ------------------------------------------------------------------
    def _single(self, kind: str, key: bytes, op):
        si = self.shard_of(key)
        self.shard_ops[si] += 1
        sh = self.shards[si]
        win = self._shard_window(sh)
        out = op(sh)
        dt, spans, degraded = self._shard_slice(sh, win)
        if dt > 0.0 or spans:
            if degraded:
                kind += "_DEG"
            self._record_facade(kind, [(si, dt, spans)])
        return out

    def set(self, key: bytes, value: bytes, proxy_id: int = 0):
        return self._single("SET", key,
                            lambda sh: sh.set(key, value, proxy_id))

    def get(self, key: bytes, proxy_id: int = 0):
        return self._single("GET", key, lambda sh: sh.get(key, proxy_id))

    def update(self, key: bytes, value: bytes, proxy_id: int = 0) -> bool:
        return self._single("UPDATE", key,
                            lambda sh: sh.update(key, value, proxy_id))

    def delete(self, key: bytes, proxy_id: int = 0) -> bool:
        return self._single("DELETE", key,
                            lambda sh: sh.delete(key, proxy_id))

    # ------------------------------------------------------------------
    # multi-key API — cross-shard scatter/gather planner
    # ------------------------------------------------------------------
    def _plan(self, keys) -> dict[int, list[int]]:
        """Group request indices per shard, preserving request order."""
        groups: dict[int, list[int]] = {}
        for i, key in enumerate(keys):
            groups.setdefault(self.shard_of(key), []).append(i)
        return groups

    def _scatter(self, fn, groups: dict[int, list[int]]):
        """Run ``fn(shard_index, request_indices)`` for every shard group.

        Groups are issued idle-engines-first: shards are ordered by their
        engine's cumulative modeled-busy clock (``modeled_busy_s``, fed
        by every coding call), shard id as the deterministic tie-break —
        the serial path drains idle engines before queueing behind busy
        ones, and the thread pool submits them first.  With pipelining,
        groups execute on one worker per shard (each worker touches only
        its own shard's state, so this is safe and deterministic);
        results return in issue order either way.
        """
        items = sorted(groups.items(),
                       key=lambda kv: (self.engines[kv[0]].modeled_busy_s,
                                       kv[0]))
        for si, idxs in items:
            self.shard_ops[si] += len(idxs)
        if self.pipeline and len(items) > 1:
            # per-call pool: workers release with the call (no idle
            # threads outliving the batch), spawn cost is negligible
            # next to the per-shard engine + store work
            with ThreadPoolExecutor(max_workers=len(items)) as pool:
                futures = [(si, idxs, pool.submit(fn, si, idxs))
                           for si, idxs in items]
                return [(si, idxs, f.result()) for si, idxs, f in futures]
        return [(si, idxs, fn(si, idxs)) for si, idxs in items]

    def _record_facade(self, kind: str, entries) -> float:
        """Record one facade request from its per-shard slices
        (``entries``: (shard id, modeled seconds, grafted spans)).

        The merged latency is the slowest shard's slice (full pipeline
        overlap across disjoint shard hardware).  In open-loop event mode
        the request is one event against the facade runtime — each
        involved shard's "sh{i}" resource clock is held for that shard's
        share, so back-to-back requests hitting the same hot shard queue
        there while disjoint shards overlap.  When tracing, the grafted
        shard span trees become per-shard groups under the facade root
        (one Chrome-trace pid per shard)."""
        service = max(dt for _, dt, _ in entries)
        net = self.net.local
        tr = net.tracer
        if tr is not None:
            tr.push()
            groups = []
            for si, dt, spans in entries:
                g = Span(f"sh{si}", "shard", dt, "seq",
                         children=list(spans or []), meta={"shard": si})
                _fill_seq(g)
                groups.append(g)
            if len(groups) == 1:
                tr.add(groups[0])
            else:
                tr.add(Span("scatter", "merge", service, "par",
                            children=groups))
        if net.events is not None:
            busy = {}
            for si, dt, _ in entries:
                busy[f"sh{si}"] = busy.get(f"sh{si}", 0.0) + dt
            net.service.record(kind, service)
            detail = {} if tr is not None else None
            lat = net.events.submit(kind, service, busy, detail_out=detail)
            if tr is not None:
                detail["service"] = service
                tr.finish(kind, lat, detail=detail)
            net.recorder.record(kind, lat)
        else:
            # closed loop: NetSim.record finishes the open span frame
            net.record(kind, service)
        return service

    def _record_batch(self, kind: str, dts):
        """Facade record for one scatter/gathered batch; ``dts``:
        (shard id, modeled seconds, grafted spans) triples."""
        if not dts:
            return
        service = self._record_facade(kind, dts)
        self._stats["cross_shard_batches"] += 1
        if len(dts) > 1:
            self._stats["pipelined_batches"] += 1
            self._stats["pipeline_overlap_saved_s"] += \
                sum(dt for _, dt, _ in dts) - service

    def multi_get(self, keys, proxy_id: int | None = 0) -> list:
        keys = list(keys)
        groups = self._plan(keys)
        out: list = [None] * len(keys)

        def run(si, idxs):
            sh = self.shards[si]
            win = self._shard_window(sh)
            vals = sh.multi_get([keys[i] for i in idxs], proxy_id)
            dt, spans, _ = self._shard_slice(sh, win)
            return vals, dt, spans

        dts = []
        for si, idxs, (vals, dt, spans) in self._scatter(run, groups):
            for i, v in zip(idxs, vals):
                out[i] = v
            dts.append((si, dt, spans))
        self._record_batch("MGET", dts)
        return out

    def multi_set(self, items, proxy_id: int | None = 0) -> list[bool]:
        items = list(items)
        groups = self._plan([k for k, _ in items])
        ok = [False] * len(items)

        def run(si, idxs):
            sh = self.shards[si]
            win = self._shard_window(sh)
            oks = sh.multi_set([items[i] for i in idxs], proxy_id)
            dt, spans, _ = self._shard_slice(sh, win)
            return oks, dt, spans

        dts = []
        for si, idxs, (oks, dt, spans) in self._scatter(run, groups):
            for i, o in zip(idxs, oks):
                ok[i] = o
            dts.append((si, dt, spans))
        self._record_batch("MSET", dts)
        return ok

    def multi_update(self, items, proxy_id: int | None = 0) -> list[bool]:
        items = list(items)
        groups = self._plan([k for k, _ in items])
        ok = [False] * len(items)

        def run(si, idxs):
            sh = self.shards[si]
            win = self._shard_window(sh)
            oks = sh.multi_update([items[i] for i in idxs], proxy_id)
            dt, spans, _ = self._shard_slice(sh, win)
            return oks, dt, spans

        dts = []
        for si, idxs, (oks, dt, spans) in self._scatter(run, groups):
            for i, o in zip(idxs, oks):
                ok[i] = o
            dts.append((si, dt, spans))
        self._record_batch("MUPDATE", dts)
        return ok

    # ------------------------------------------------------------------
    # elasticity — membership changes + skew-aware rebalancing, executed
    # as live stripe migrations (core/rebalance.py)
    # ------------------------------------------------------------------
    def add_shard(self, weight: float = 1.0, engine=None, migrate: bool = True,
                  max_moves: int | None = None, batch_size: int = 64,
                  step_cb=None) -> dict:
        """Grow the cluster by one shard store and (by default) migrate
        the key ranges the new placement assigns to it — live: client
        requests interleave at every ``step_cb`` batch boundary.  Returns
        the migration report (``moved_keys``/``moved_bytes``/...)."""
        from .engine import engine_specs
        from .rebalance import Rebalancer
        new_id = len(self.shards)
        if engine is None:
            # extend the construction-time spec's cycle to the new slot
            engine = engine_specs(self._engine_spec, new_id + 1)[new_id]
        sh = MemECCluster(engine=engine, shard_id=new_id, **self._cluster_kw)
        self.shards.append(sh)
        self.engines.append(sh.engine)
        self.shard_ops.append(0)
        self.num_shards = len(self.shards)
        self.placement.add_shard(new_id, weight=weight)
        report = {"shard": new_id, "moved_keys": 0, "moved_bytes": 0}
        rb = Rebalancer(self, batch_size=batch_size)
        if migrate:
            report.update(rb.run(max_moves=max_moves, step_cb=step_cb))
            report["shard"] = new_id
        else:
            # no data moves yet, but the forwarding table must still be
            # installed — the new placement already routes ~1/S of keys
            # to the (empty) new shard, and they'd read as missing
            plan = rb.plan()
            report["mismatched"] = plan.mismatched
            report["pending_left"] = len(self._pending)
        return report

    def remove_shard(self, shard: int, batch_size: int = 64,
                     step_cb=None) -> dict:
        """Retire a shard: drop it from the placement, then drain every
        resident key to its new home (always a full drain — a retired
        store must end empty).  The store object stays in ``shards`` so
        global server ids and netsim endpoint names remain stable."""
        from .rebalance import Rebalancer
        if shard in self.retired or shard not in self.placement.shard_ids:
            raise ValueError(f"no active shard {shard}")
        self.placement.remove_shard(shard)
        self.retired.add(shard)
        rb = Rebalancer(self, batch_size=batch_size)
        report = rb.run(step_cb=step_cb)
        report["shard"] = shard
        return report

    def rebalance(self, max_moves: int | None = None,
                  skew_threshold: float = 1.25, batch_size: int = 64,
                  step_cb=None, reset_load: bool = True) -> dict:
        """Skew-aware rebalancing: when the per-shard load skew
        (max/mean ``shard_ops``) crosses ``skew_threshold``, shift ring
        weights inversely to observed load and migrate — capped at
        ``max_moves`` keys (the rest stays forwarded until a later pass).
        Requires a weighted placement (ring); the mod placement reports
        itself unsupported rather than reshuffling everything."""
        from .rebalance import Rebalancer, skewed_weights
        skew = self.load_skew()
        report = {"skew_before": skew, "moved_keys": 0, "moved_bytes": 0}
        if skew <= skew_threshold:
            report["skipped"] = "skew below threshold"
            return report
        if not self.placement.supports_weights:
            report["skipped"] = (f"{self.placement.kind} placement does not "
                                 "support weighted rebalancing")
            return report
        loads = {s: float(self.shard_ops[s])
                 for s in self.placement.shard_ids}
        weights = skewed_weights(self.placement, loads)
        for s, w in weights.items():
            self.placement.set_weight(s, w)
        rb = Rebalancer(self, batch_size=batch_size)
        report.update(rb.run(max_moves=max_moves, step_cb=step_cb))
        report["skew_before"] = skew
        report["weights"] = weights
        if reset_load:
            self.reset_load()
        return report

    # ------------------------------------------------------------------
    # shard-scoped failure transitions — one shard's recovery never
    # blocks the others' traffic
    # ------------------------------------------------------------------
    def fail_server(self, sid: int, shard: int | None = None,
                    recover: bool = True) -> dict:
        shard, local = self._resolve_server(sid, shard)
        timings = self.shards[shard].fail_server(local, recover=recover)
        timings["shard"] = shard
        return timings

    def restore_server(self, sid: int, shard: int | None = None) -> dict:
        shard, local = self._resolve_server(sid, shard)
        timings = self.shards[shard].restore_server(local)
        timings["shard"] = shard
        return timings

    def flush_hot_buffers(self) -> int:
        """Drain every shard's hot-key version buffer; returns the total
        number of buffered entries folded back into their stripes."""
        return sum(sh.flush_hot_buffers() for sh in self.shards)

    def inflate_server(self, sid: int, factor: float,
                       shard: int | None = None) -> dict:
        """Slow-server injection (straggler axis): latency-inflate one
        server's legs by ``factor`` inside its shard; ``factor=1.0``
        restores.  Facade event gating stays whole-shard (``sh{i}``)
        granularity — the inflation lands in the shard's phase algebra
        and therefore in the facade-recorded latency."""
        shard, local = self._resolve_server(sid, shard)
        self.shards[shard].inflate_server(local, factor)
        return {"shard": shard, "server": local, "factor": factor}

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def total_memory(self) -> dict:
        agg: dict[str, int] = {}
        for sh in self.shards:
            for k, v in sh.total_memory().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def stored_payload_bytes(self) -> int:
        return sum(sh.stored_payload_bytes() for sh in self.shards)


def make_cluster(shards=None, engine=None, pipeline: bool = True,
                 placement=None, **cluster_kw):
    """Cluster factory: plain ``MemECCluster`` for S=1 (the unsharded
    special case — byte- and latency-identical to the pre-sharding
    cluster, no placement machinery attached), ``ShardedCluster`` for
    S>1.  ``shards=None`` reads ``$MEMEC_SHARDS``; ``placement=None``
    reads ``$MEMEC_PLACEMENT`` (``mod`` | ``ring`` | ``ring:<vnodes>``,
    default ``mod``)."""
    s = resolve_shards(shards)
    if s == 1:
        from .engine import engine_specs
        return MemECCluster(engine=engine_specs(engine, 1)[0], **cluster_kw)
    return ShardedCluster(shards=s, engine=engine, pipeline=pipeline,
                          placement=placement, **cluster_kw)
