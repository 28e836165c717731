"""Network cost model + accounting for the in-process cluster simulation.

The paper evaluates MemEC on a Gigabit LAN (125 MB/s, sub-ms RTT) and
simulates transient failures with tc-netem (normal(2ms, 1ms) delay per
packet).  The simulation executes requests in-process and *models* time:

    leg(bytes)           = rtt + bytes / bw + proc          (one message)
    phase(parallel legs) = max(leg costs)                    (fan-out)
    request latency      = sum of its phases

Two outputs feed the benchmarks:
* latency — per-request modeled time (sum of phases);
* throughput — bottleneck-based: the busiest endpoint's byte traffic
  divided by link bandwidth bounds aggregate ops/s (this is what actually
  limits the paper's Gigabit testbed, e.g. the (n-k+1)-way SET fan-out).

Coding cost (PR 4): ``CostModel.coding_s`` converts a ``CodingEngine``
work-bytes figure into modeled seconds (GF(2^8) table-lookup throughput
plus a fixed per-call dispatch).  The synchronous store adds it serially
to the request phases; the async pipeline (``async_engine=True``) merges
it as ``max(coding, network)`` per phase — the overlap the paper hides
coding behind.

Engine queue (PR 5): concurrent engine calls submitted in one overlapped
phase (e.g. per-parity seal folds) contend for ``CostModel.engine_depth``
execution lanes.  The phase's coding duration is ``engine_makespan`` —
a depth-limited LPT schedule that degenerates to ``max`` at the default
infinite depth — so ``max(coding, network)`` is a queue-aware merge and
``stats["engine_queue_wait_s"]`` exposes the bound on hiding.

Concurrent lanes: ``merge_lanes`` models independent request pipelines
(e.g. per-proxy sub-batches of one multi-key request) running at the
same time.  Lanes overlap freely, but a server appearing in several
lanes serializes its own legs — the merged duration is
``max(slowest lane, busiest shared endpoint)``, clamped by the fully
serial sum.  Per-endpoint busy time is tracked in ``time_by_endpoint``
(snapshot/diff via ``busy_snapshot``).

Event runtime (PR 7): the phase algebra above prices one request in
isolation — a busy engine never delays the *next* request.  With an
open-loop ``ArrivalProcess`` (``arrival=`` / ``$MEMEC_ARRIVAL``:
``poisson:RATE`` / ``uniform:RATE`` / ``trace:T0,T1,...``), every
recorded request additionally becomes a discrete event in an
``EventRuntime``: arrival drawn from the process, start gated FCFS on
admission slots (``inflight`` client contexts), per-endpoint link
occupancy clocks (``time_by_endpoint`` deltas) and
``CostModel.engine_depth`` coding lanes, completion = start + service.
Recorded latency then includes queue wait, so ``p50/p99/p999`` per
request kind reflect contention; the pure phase-algebra service times
stay available in ``NetSim.service``.  The default ``closed`` process
keeps the historical numbers bit-identical (no event machinery at all),
and ``inflight=1`` with rate→inf degenerates back to the serial
closed-loop totals (property-tested in tests/test_event_runtime.py).
"""
from __future__ import annotations

import dataclasses
import os
from collections import defaultdict


@dataclasses.dataclass
class Leg:
    kind: str
    nbytes: int
    src: str = ""
    dst: str = ""
    to_failed: bool = False


@dataclasses.dataclass
class CostModel:
    rtt_s: float = 0.0002          # LAN round-trip
    bw_Bps: float = 125e6          # Gigabit
    proc_s: float = 2e-6           # per-message processing
    failed_delay_s: float = 0.002  # injected delay to a congested server
    header_bytes: int = 24         # protocol header per message
    # GF(2^8) coding throughput of one server core (table-lookup mults;
    # the paper's servers run coding on CPU) + fixed per-engine-call
    # dispatch.  Consumed via `coding_s` with a CodingEngine work-bytes
    # figure; shrink `coding_Bps` to model a coding-bound deployment.
    coding_Bps: float = 2.5e9
    coding_fixed_s: float = 2e-6
    # concurrent-call capacity of one shard's coding engine: engine
    # calls submitted within one overlapped phase contend for this many
    # execution lanes.  inf (default) is the historical no-contention
    # assumption — every modeled latency is unchanged at depth=inf;
    # finite depths bound how much coding the pipeline can hide and
    # surface the extra wait as stats["engine_queue_wait_s"].
    engine_depth: float = float("inf")

    def leg(self, payload_bytes: int, to_failed: bool = False) -> float:
        t = self.rtt_s + (payload_bytes + self.header_bytes) / self.bw_Bps + self.proc_s
        if to_failed:
            t += self.failed_delay_s
        return t

    def coding_s(self, work_bytes: float, calls: int = 1) -> float:
        """Modeled duration of a batched coding-engine call."""
        if work_bytes <= 0 and calls <= 0:
            return 0.0
        return calls * self.coding_fixed_s + work_bytes / self.coding_Bps

    def engine_makespan(self, durations) -> float:
        """Completion time of engine calls submitted concurrently.

        Longest-processing-time greedy onto ``engine_depth`` lanes —
        deterministic and within 4/3 of optimal.  At the default
        ``inf`` depth (or when the calls fit the lanes) this is just
        ``max(durations)``, the historical infinite-concurrency merge.
        """
        ds = sorted((d for d in durations if d > 0), reverse=True)
        if not ds:
            return 0.0
        depth = self.engine_depth
        if depth == float("inf") or len(ds) <= depth:
            return ds[0]
        lanes = [0.0] * max(1, int(depth))
        for d in ds:
            i = min(range(len(lanes)), key=lanes.__getitem__)
            lanes[i] += d
        return max(lanes)


class LatencyRecorder:
    """Single source of truth for latency aggregation.

    Both the unsharded ``NetSim`` and the sharded facade report from one
    of these, so percentile/mean formulas cannot diverge between paths
    (they used to be copy-pasted into ``core/shard.py``).
    ``total_recorded_s`` is monotonic — it survives ``clear()`` so
    callers can take O(1) before/after snapshots of modeled time.
    """

    PERCENTILES = ((50.0, "p50_s"), (99.0, "p99_s"), (99.9, "p999_s"))

    def __init__(self):
        self.latencies: dict[str, list[float]] = defaultdict(list)
        self.ops_by_kind: dict[str, int] = defaultdict(int)
        self.total_recorded_s = 0.0

    def record(self, kind: str, latency_s: float):
        self.latencies[kind].append(latency_s)
        self.ops_by_kind[kind] += 1
        self.total_recorded_s += latency_s

    @staticmethod
    def percentile_of(xs, q: float) -> float:
        import numpy as np
        if not xs:
            return float("nan")
        return float(np.percentile(xs, q))

    @staticmethod
    def mean_of(xs) -> float:
        return sum(xs) / len(xs) if xs else float("nan")

    def percentile(self, kind: str, q: float) -> float:
        return self.percentile_of(self.latencies.get(kind, []), q)

    def mean(self, kind: str) -> float:
        return self.mean_of(self.latencies.get(kind, []))

    @classmethod
    def summary_of(cls, xs) -> dict:
        out = {"count": len(xs), "mean_s": cls.mean_of(xs)}
        for q, name in cls.PERCENTILES:
            out[name] = cls.percentile_of(xs, q)
        return out

    def summary(self) -> dict:
        """``{kind: {count, mean_s, p50_s, p99_s, p999_s}}``."""
        return {k: self.summary_of(xs)
                for k, xs in sorted(self.latencies.items())}

    def clear(self):
        self.latencies.clear()
        self.ops_by_kind.clear()


class ArrivalProcess:
    """Open-loop arrival-time generator for the event runtime.

    Specs (``arrival=`` ctor arg, else ``$MEMEC_ARRIVAL``, else closed):

    * ``closed`` — the historical closed loop: the next request is
      issued when the previous completes.  No event machinery runs.
    * ``poisson:RATE`` — seeded exponential inter-arrival gaps at RATE
      req/s (``inf`` → zero gaps, i.e. everything arrives at t=0).
    * ``uniform:RATE`` — deterministic 1/RATE gaps.
    * ``trace:T0,T1,...`` — explicit arrival times in seconds; the gap
      pattern cycles if the workload outruns the trace.

    Extra ``:key=val`` fields: ``seed=N`` (poisson rng),
    ``inflight=K`` (concurrent client contexts admitted by the
    EventRuntime; default 1 matches the sequential closed-loop driver).
    """

    def __init__(self, kind: str = "closed", rate: float | None = None,
                 seed: int = 0, inflight: int = 1,
                 trace: list[float] | None = None):
        if kind not in ("closed", "poisson", "uniform", "trace"):
            raise ValueError(f"unknown arrival kind: {kind!r}")
        self.kind = kind
        self.rate = rate
        self.seed = int(seed)
        self.inflight = max(1, int(inflight))
        self.trace = list(trace or [])
        if kind in ("poisson", "uniform") and not (rate and rate > 0):
            raise ValueError(f"{kind} arrival needs a positive rate")
        if kind == "trace" and not self.trace:
            raise ValueError("trace arrival needs at least one time")
        self.reset()

    @classmethod
    def parse(cls, spec: str) -> "ArrivalProcess":
        parts = [p for p in str(spec).strip().split(":") if p != ""]
        if not parts:
            return cls("closed")
        kind, args = parts[0].lower(), parts[1:]
        kw: dict = {}
        for a in args:
            if "=" in a:
                key, val = a.split("=", 1)
                if key == "seed":
                    kw["seed"] = int(val)
                elif key == "inflight":
                    kw["inflight"] = int(val)
                else:
                    raise ValueError(f"unknown arrival option: {a!r}")
            elif kind == "trace":
                if a.startswith("@"):
                    # trace:@capture.json — a TraceCapture file
                    import json
                    with open(a[1:]) as f:
                        doc = json.load(f)
                    kw["trace"] = [float(t) for t in doc["arrivals"]]
                    kw.setdefault("inflight", int(doc.get("inflight", 1)))
                else:
                    kw["trace"] = [float(t) for t in a.split(",")]
            else:
                kw["rate"] = float(a)
        return cls(kind, **kw)

    @property
    def open_loop(self) -> bool:
        return self.kind != "closed"

    def reset(self):
        import numpy as np
        self._t = 0.0
        self._rng = np.random.default_rng(self.seed)
        self._trace_i = 0
        if self.kind == "trace":
            ts = self.trace
            self._gaps = [ts[0]] + [b - a for a, b in zip(ts, ts[1:])]

    def next_arrival(self) -> float:
        """Absolute arrival time of the next request (monotonic)."""
        if self.kind == "poisson":
            gap = 0.0 if self.rate == float("inf") else \
                float(self._rng.exponential(1.0 / self.rate))
        elif self.kind == "uniform":
            gap = 0.0 if self.rate == float("inf") else 1.0 / self.rate
        elif self.kind == "trace":
            gap = self._gaps[self._trace_i % len(self._gaps)]
            self._trace_i += 1
        else:  # closed — never driven through the event runtime
            gap = 0.0
        self._t = max(0.0, self._t + gap)
        return self._t

    def describe(self) -> dict:
        d = {"kind": self.kind, "inflight": self.inflight}
        if self.rate is not None:
            d["rate"] = self.rate
        if self.kind == "poisson":
            d["seed"] = self.seed
        if self.kind == "trace":
            d["trace_len"] = len(self.trace)
        return d


def resolve_arrival(arrival=None, env: str = "MEMEC_ARRIVAL") -> ArrivalProcess:
    """Ctor arg wins; else ``$MEMEC_ARRIVAL``; else the closed loop."""
    if isinstance(arrival, ArrivalProcess):
        return arrival
    if arrival is None:
        arrival = os.environ.get(env) or "closed"
    return ArrivalProcess.parse(arrival)


class EventRuntime:
    """Discrete-event scheduling overlay over eager request execution.

    Requests still *execute* eagerly in program order — what the runtime
    replays is time.  Each recorded request becomes one event chain:

        arrival    — drawn from the open-loop ArrivalProcess
        start      — max(arrival, FCFS resource clocks)
        completion — start + service   (service = phase-algebra latency)

    Resources, each a ``free_at`` clock:

    * admission slots: ``arrival.inflight`` concurrent client contexts.
      ``inflight=1`` is the sequential closed-loop driver — at rate→inf
      it reproduces the serial phase-algebra totals (makespan ==
      sum(service) up to link-occupancy overhang).
    * per-endpoint links: held for the request's ``time_by_endpoint``
      occupancy delta — two admitted requests hammering the same server
      NIC serialize there.
    * coding-engine lanes: ``CostModel.engine_depth`` lanes held for the
      request's modeled coding seconds (``NetSim.note_coding``) — a busy
      engine delays the next request's submit.  Infinite depth keeps the
      historical no-contention assumption.

    Queue wait = start − arrival, with a per-resource breakdown
    (clipped maxima, not additive — waits overlap).
    """

    RESOURCES = ("admission", "endpoint", "engine")

    def __init__(self, cost: CostModel, arrival: ArrivalProcess):
        self.cost = cost
        self.arrival = arrival
        self.slots = [0.0] * arrival.inflight
        self.link_free: dict[str, float] = defaultdict(float)
        depth = cost.engine_depth
        self.engine_lanes = ([] if depth == float("inf")
                             else [0.0] * max(1, int(depth)))
        self.waits = LatencyRecorder()
        self.wait_s_by_resource: dict[str, float] = dict.fromkeys(
            self.RESOURCES, 0.0)
        # (seq, kind, arrival, start, completion) — determinism probe
        self.events: list[tuple] = []
        self.makespan_s = 0.0
        self.offered = 0

    def engine_ready_at(self) -> float:
        """When the earliest coding lane frees up (0.0 = idle/unbounded);
        the scatter/gather planner uses this to prefer idle engines."""
        return min(self.engine_lanes) if self.engine_lanes else 0.0

    def submit(self, kind: str, service_s: float,
               busy: dict[str, float] | None = None,
               engine_s: float = 0.0,
               detail_out: dict | None = None,
               optional: dict[str, float] | None = None) -> float:
        """Schedule one request; returns its latency incl. queue wait.

        ``optional`` maps endpoint -> occupancy seconds the request put
        on the wire but did NOT wait for (redundant race legs that lost
        the k-th-arrival race).  An endpoint whose demand is entirely
        optional doesn't gate this request's start and contributes no
        endpoint queue-wait attribution — but its link clock still
        advances by the full occupancy, so *subsequent* requests queue
        behind the dropped traffic (the bytes are real).

        ``detail_out`` (tracing only): filled in place with the event's
        arrival/start/completion and per-resource ready times, plus the
        occupying endpoint (the busiest link clock among the request's
        endpoints) and the engine lane taken.
        """
        arrival = self.arrival.next_arrival()
        slot = min(range(len(self.slots)), key=self.slots.__getitem__)
        admit_ready = self.slots[slot]
        busy = busy or {}
        optional = optional or {}
        # endpoints the request actually waited on: any with demand
        # beyond what its own dropped race legs put there
        gating = [ep for ep, occ in busy.items()
                  if occ - optional.get(ep, 0.0) > 1e-18]
        link_ready = max((self.link_free[ep] for ep in gating), default=0.0)
        lane = -1
        engine_ready = 0.0
        if engine_s > 0.0 and self.engine_lanes:
            lane = min(range(len(self.engine_lanes)),
                       key=self.engine_lanes.__getitem__)
            engine_ready = self.engine_lanes[lane]
        start = max(arrival, admit_ready, link_ready, engine_ready)
        if detail_out is not None:
            endpoint = (max(gating, key=lambda ep: self.link_free[ep])
                        if gating else "")
            detail_out.update(arrival=arrival, start=start,
                              completion=start + service_s,
                              admit_ready=admit_ready,
                              link_ready=link_ready,
                              engine_ready=engine_ready,
                              endpoint=endpoint, lane=lane)
        completion = start + service_s
        self.slots[slot] = completion
        for ep, occ in busy.items():
            # gating endpoints have link_free <= start (they set
            # link_ready), so this is start + occ as before; a purely
            # optional endpoint may still be draining earlier traffic,
            # and its dropped bytes append behind that queue instead of
            # rewinding the clock
            self.link_free[ep] = max(self.link_free[ep], start) + occ
        if lane >= 0:
            self.engine_lanes[lane] = start + engine_s
        wait = start - arrival
        self.waits.record(kind, wait)
        self.wait_s_by_resource["admission"] += min(
            wait, max(0.0, admit_ready - arrival))
        self.wait_s_by_resource["endpoint"] += min(
            wait, max(0.0, link_ready - arrival))
        self.wait_s_by_resource["engine"] += min(
            wait, max(0.0, engine_ready - arrival))
        self.events.append((self.offered, kind, arrival, start, completion))
        self.offered += 1
        self.makespan_s = max(self.makespan_s, completion)
        return completion - arrival

    def snapshot(self) -> dict:
        return {
            "arrival": self.arrival.describe(),
            "offered": self.offered,
            "makespan_s": self.makespan_s,
            "queue_wait_s": self.waits.total_recorded_s,
            "queue_wait_s_by_kind": {
                k: sum(xs) for k, xs in sorted(self.waits.latencies.items())},
            "queue_wait_s_by_resource": dict(self.wait_s_by_resource),
        }


class NetSim:
    """Accumulates modeled time and byte counters."""

    def __init__(self, cost: CostModel | None = None, arrival=None,
                 trace=None):
        from .trace import resolve_trace
        self.cost = cost or CostModel()
        # per-request span tracer (None when off — the zero-cost default)
        self.tracer = resolve_trace(trace)
        self.bytes_by_kind: dict[str, int] = defaultdict(int)
        self.msgs_by_kind: dict[str, int] = defaultdict(int)
        self.bytes_by_endpoint: dict[str, int] = defaultdict(int)
        # modeled link-occupancy seconds (wire bytes over bandwidth) per
        # endpoint — the per-server serialization floor for concurrent
        # lanes.  Occupancy only: RTT/processing pipeline across legs, so
        # they don't serialize; draining bytes through one NIC does.
        self.time_by_endpoint: dict[str, float] = defaultdict(float)
        # recorded request latencies (incl. queue wait in event mode);
        # `latencies`/`ops_by_kind` alias the recorder's dicts so legacy
        # readers keep working, and `total_recorded_s` (monotonic sum,
        # survives reset) is a property over the recorder
        self.recorder = LatencyRecorder()
        self.latencies = self.recorder.latencies
        self.ops_by_kind = self.recorder.ops_by_kind
        # pure phase-algebra service times (== recorder in closed mode;
        # in event mode the queue-free component of each latency)
        self.service = LatencyRecorder()
        self.arrival = resolve_arrival(arrival)
        self.events = (EventRuntime(self.cost, self.arrival)
                       if self.arrival.open_loop else None)
        self._event_busy_mark: dict[str, float] = {}
        self._pending_coding_s = 0.0
        # slow-server injection: endpoint -> latency/occupancy multiplier
        # (the straggler axis — a server that is slow, not failed).
        # Persists across reset(), like injected failures do.
        self.inflation: dict[str, float] = {}
        # occupancy put on the wire by race legs that lost the
        # k-of-(k+Δ) race since the last record() — the request did not
        # wait for it, so the event runtime must not gate on it
        self._pending_optional: dict[str, float] = defaultdict(float)

    @property
    def total_recorded_s(self) -> float:
        return self.recorder.total_recorded_s

    # -- slow-server injection (straggler axis) -------------------------
    def inflate(self, endpoint: str, factor: float):
        """Latency-inflate one endpoint by ``factor`` (e.g. 10.0 = a
        server answering 10x slower).  Every leg touching the endpoint
        has both its modeled cost and its link occupancy multiplied —
        a straggler is slow on the wire, not just far away.  ``factor
        == 1.0`` removes the injection; the axis survives ``reset()``
        (like injected failures) so a measurement window keeps it."""
        if not (factor > 0.0):
            raise ValueError(f"inflate factor must be > 0, got {factor!r}")
        if factor == 1.0:
            self.inflation.pop(endpoint, None)
        else:
            self.inflation[endpoint] = float(factor)

    def _inflation_of(self, leg: Leg) -> float:
        if not self.inflation:
            return 1.0
        return max(self.inflation.get(leg.src, 1.0),
                   self.inflation.get(leg.dst, 1.0))

    # -- request construction ------------------------------------------
    def _account_leg(self, leg: Leg) -> float:
        """Byte/message/occupancy accounting shared by every phase
        flavor; returns the leg's modeled cost."""
        wire = leg.nbytes + self.cost.header_bytes
        self.bytes_by_kind[leg.kind] += wire
        self.msgs_by_kind[leg.kind] += 1
        factor = self._inflation_of(leg)
        occupancy = wire / self.cost.bw_Bps * factor
        if leg.src:
            self.bytes_by_endpoint[leg.src] += wire
            self.time_by_endpoint[leg.src] += occupancy
        if leg.dst:
            self.bytes_by_endpoint[leg.dst] += wire
            self.time_by_endpoint[leg.dst] += occupancy
        return self.cost.leg(leg.nbytes, leg.to_failed) * factor

    def phase(self, legs: list[Leg]) -> float:
        if self.tracer is None:
            worst = 0.0
            for leg in legs:
                worst = max(worst, self._account_leg(leg))
            return worst
        pairs = [(leg, self._account_leg(leg)) for leg in legs]
        worst = max((c for _, c in pairs), default=0.0)
        self.tracer.phase(worst, pairs)
        return worst

    def race_phase(self, groups: list[tuple[str, list[Leg]]],
                   need: int) -> tuple[float, list[int], list[int]]:
        """k-of-(k+Δ) fan-out: complete at the ``need``-th arrival.

        Each group is one candidate responder's full round trip
        (request leg + response leg); its arrival time is the sum of its
        leg costs.  The phase completes when ``need`` groups have
        arrived — the slowest Δ are *dropped*: their bytes, messages and
        link occupancy are all accounted (redundant traffic is real and
        future requests queue behind it), but they do not contribute to
        this request's latency, and in event mode their occupancy is
        flagged optional so the EventRuntime doesn't gate on it.

        Returns ``(t, winner_idxs, dropped_idxs)`` with deterministic
        (cost, index) tie-breaking.  Identical ``t`` with tracing on or
        off.
        """
        need = min(need, len(groups))
        entries = []   # (cost, idx, label, legs)
        for idx, (label, legs) in enumerate(groups):
            cost = sum(self._account_leg(leg) for leg in legs)
            entries.append((cost, idx, label, legs))
        ranked = sorted(entries, key=lambda e: (e[0], e[1]))
        t = ranked[need - 1][0] if need > 0 else 0.0
        winners = sorted(idx for _, idx, _, _ in ranked[:need])
        dropped = sorted(idx for _, idx, _, _ in ranked[need:])
        for cost, idx, label, legs in ranked[need:]:
            for leg in legs:
                wire = leg.nbytes + self.cost.header_bytes
                occ = wire / self.cost.bw_Bps * self._inflation_of(leg)
                if leg.src:
                    self._pending_optional[leg.src] += occ
                if leg.dst:
                    self._pending_optional[leg.dst] += occ
        if self.tracer is not None:
            won = set(winners)
            self.tracer.race(
                t, [(label, cost, idx in won)
                    for cost, idx, label, _ in sorted(entries,
                                                      key=lambda e: e[1])])
        return t, winners, dropped

    def serialized_phase(self, legs: list[Leg]) -> float:
        """Bulk-transfer phase: each destination drains its inbound legs
        sequentially (link-limited), destinations proceed in parallel —
        max over dst of sum(leg costs).  Use where volume, not a single
        RTT, dominates (e.g. batched recovery); `phase` would report the
        max single leg regardless of how much data moves."""
        per_dst: dict[str, float] = defaultdict(float)
        if self.tracer is None:
            for leg in legs:
                per_dst[leg.dst] += self._account_leg(leg)
            return max(per_dst.values()) if per_dst else 0.0
        pairs = []
        for leg in legs:
            cost = self._account_leg(leg)
            per_dst[leg.dst] += cost
            pairs.append((leg, cost))
        worst = max(per_dst.values()) if per_dst else 0.0
        self.tracer.drain(worst, dict(per_dst), pairs)
        return worst

    # -- concurrent lanes (cross-proxy pipelining) ----------------------
    def busy_snapshot(self) -> dict[str, float]:
        """Copy of per-endpoint busy seconds; diff two snapshots around a
        lane's execution to get that lane's endpoint occupancy."""
        return dict(self.time_by_endpoint)

    @staticmethod
    def busy_delta(before: dict[str, float],
                   after: dict[str, float]) -> dict[str, float]:
        return {ep: t - before.get(ep, 0.0) for ep, t in after.items()
                if t - before.get(ep, 0.0) > 0.0}

    @staticmethod
    def merge_lanes(lane_durations: list[float],
                    lane_busys: list[dict[str, float]]) -> float:
        """Merged duration of concurrently executing lanes.

        Lanes overlap freely (independent proxies driving disjoint
        sub-batches), but any endpoint shared by several lanes serializes
        its own legs: the merged time is the slowest lane or the busiest
        endpoint's total occupancy, whichever is larger — and never worse
        than running the lanes back to back."""
        if not lane_durations:
            return 0.0
        serial = sum(lane_durations)
        busy: dict[str, float] = defaultdict(float)
        for b in lane_busys:
            for ep, t in b.items():
                busy[ep] += t
        floor = max(busy.values(), default=0.0)
        return min(serial, max(max(lane_durations), floor))

    def note_coding(self, coding_s: float):
        """Event-mode demand capture: modeled engine-busy seconds charged
        to the request currently executing (no-op in closed-loop mode —
        the phase algebra already merged them into the latency)."""
        if self.events is not None and coding_s > 0.0:
            self._pending_coding_s += coding_s

    def record(self, req_kind: str, latency_s: float) -> float:
        """Record one finished request.

        Closed loop: the phase-algebra latency is recorded verbatim (the
        historical numbers, bit-identical).  Open loop: the request is
        additionally submitted to the EventRuntime — its endpoint demand
        is the ``time_by_endpoint`` delta since the previous record, its
        engine demand the coding seconds noted via ``note_coding`` — and
        the recorded latency includes the FCFS queue wait."""
        if self.events is None:
            self._pending_optional.clear()
            if self.tracer is not None:
                self.tracer.finish(req_kind, latency_s)
            self.recorder.record(req_kind, latency_s)
            return latency_s
        busy = self.busy_delta(self._event_busy_mark, self.time_by_endpoint)
        self._event_busy_mark = self.busy_snapshot()
        engine_s, self._pending_coding_s = self._pending_coding_s, 0.0
        optional = (dict(self._pending_optional)
                    if self._pending_optional else None)
        self._pending_optional.clear()
        self.service.record(req_kind, latency_s)
        detail = {} if self.tracer is not None else None
        lat = self.events.submit(req_kind, latency_s, busy, engine_s,
                                 detail_out=detail, optional=optional)
        if self.tracer is not None:
            detail["service"] = latency_s
            self.tracer.finish(req_kind, lat, detail=detail)
        self.recorder.record(req_kind, lat)
        return lat

    # -- reporting -------------------------------------------------------
    def percentile(self, req_kind: str, q: float) -> float:
        return self.recorder.percentile(req_kind, q)

    def mean(self, req_kind: str) -> float:
        return self.recorder.mean(req_kind)

    def latency_summary(self) -> dict:
        """Per-kind count/mean/p50/p99/p999 plus, in event mode, the
        per-kind queue-wait share and the per-resource breakdown."""
        out = self.recorder.summary()
        if self.events is not None:
            for kind, s in out.items():
                ws = self.events.waits.latencies.get(kind, [])
                s["queue_wait_s"] = sum(ws)
                s["queue_wait_p99_s"] = LatencyRecorder.percentile_of(ws, 99.0)
        return out

    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def bottleneck_throughput(self, total_ops: int, endpoints: list[str] | None = None) -> float:
        """ops/s bound by the busiest endpoint's traffic over link bw
        (pessimistic under Zipf hot keys — see mean_throughput)."""
        pool = (self.bytes_by_endpoint if endpoints is None
                else {e: self.bytes_by_endpoint.get(e, 0) for e in endpoints})
        if not pool or total_ops == 0:
            return float("nan")
        worst = max(pool.values())
        if worst == 0:
            return float("inf")
        return total_ops / (worst / self.cost.bw_Bps)

    def mean_throughput(self, total_ops: int, endpoints: list[str] | None = None) -> float:
        """ops/s bound by aggregate endpoint traffic over aggregate bw —
        models a cluster that load-balances over time (the paper's long
        YCSB runs smooth Zipf hot spots across 20M requests)."""
        pool = (self.bytes_by_endpoint if endpoints is None
                else {e: self.bytes_by_endpoint.get(e, 0) for e in endpoints})
        if not pool or total_ops == 0:
            return float("nan")
        total = sum(pool.values())
        if total == 0:
            return float("inf")
        return total_ops / (total / (len(pool) * self.cost.bw_Bps))

    def reset(self):
        self.bytes_by_kind.clear()
        self.msgs_by_kind.clear()
        self.bytes_by_endpoint.clear()
        self.time_by_endpoint.clear()
        self.recorder.clear()
        self.service.clear()
        self._event_busy_mark = {}
        self._pending_coding_s = 0.0
        self._pending_optional.clear()
        if self.tracer is not None:
            self.tracer.reset()
        if self.events is not None:
            self.arrival.reset()
            self.events = EventRuntime(self.cost, self.arrival)

    def snapshot(self) -> dict:
        out = {
            "bytes_by_kind": dict(self.bytes_by_kind),
            "msgs_by_kind": dict(self.msgs_by_kind),
            "bytes_by_endpoint": dict(self.bytes_by_endpoint),
        }
        if self.events is not None:
            out["event"] = self.events.snapshot()
        return out
