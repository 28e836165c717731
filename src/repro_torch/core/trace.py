"""Per-request span tracing, critical-path attribution, capture/replay.

PR 7 made the tail measurable (``stats["latency"]`` p50/p99/p999); this
module makes it *attributable*.  With tracing enabled (``trace=`` ctor
arg or ``$MEMEC_TRACE``; off by default and zero-cost when off — no
tracer object is even allocated), every recorded request produces a
span tree:

    GET (request) ............................ dur == recorded latency
      queued (par) ........................... start - arrival
        wait:admission
        wait:endpoint:s3 ..................... occupying endpoint named
        wait:engine
      service (seq) .......................... phase-algebra latency
        get:p0->s3 (link) .................... one span per (kind, dst)
        engine:decode (engine) ............... lanes from engine_makespan
        ack:s3->p0 (link)

Span semantics are series-parallel: a ``seq`` span's children tile it
(a residual ``other`` leaf absorbs un-attributed time), a ``par``
span's duration is the max over children.  Two invariants hold for
every tree (``Span.check``): children nest inside parents, and the
max-weight root-to-leaf path — ``components(root)`` summed — equals
the recorded request latency.

On top of the spans:

* ``critical_paths(cluster)`` — per request kind, decompose the
  p50/p99/p999 *witness* request into additive wait components
  ("p99 of GET = 61% link p0->s5, 24% engine, ...").  Exported as
  telemetry v2's ``critical_path`` section.
* ``export_chrome(cluster)`` — Chrome trace-event JSON
  (Perfetto/about:tracing loadable): one pid per shard, one tid per
  server endpoint / engine lane.
* ``TraceCapture`` — record a live open-loop run's arrival timestamps
  and per-request kinds, serialize them, and replay any workload
  deterministically via ``arrival="trace:..."`` (closing the ROADMAP's
  trace-capture loop: a CI tail incident becomes a replayable file).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

# seq-residual floor: anything smaller is float noise, not a span
_EPS = 1e-15


@dataclasses.dataclass
class Span:
    """One node of a series-parallel span tree.

    ``mode``: ``leaf`` (no children), ``seq`` (children tile the span
    back to back), ``par`` (children share the span's start; duration
    is the max child).  ``t0`` is assigned by ``_layout`` once the tree
    is rooted under a request.
    """
    name: str
    cat: str = "span"
    dur: float = 0.0
    mode: str = "leaf"
    t0: float = 0.0
    children: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.t0 + self.dur

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def check(self, eps: float = 1e-9):
        """Assert the nesting + series-parallel invariants recursively."""
        for c in self.children:
            assert c.t0 >= self.t0 - eps, (self.name, c.name)
            assert c.end <= self.end + eps, (self.name, c.name)
            c.check(eps)
        if self.children:
            durs = [c.dur for c in self.children]
            if self.mode == "seq":
                assert abs(sum(durs) - self.dur) <= eps, self.name
            elif self.mode == "par":
                assert max(durs) <= self.dur + eps, self.name

    def to_dict(self) -> dict:
        d = {"name": self.name, "cat": self.cat, "dur": self.dur,
             "mode": self.mode, "t0": self.t0}
        if self.meta:
            d["meta"] = dict(self.meta)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


def _fill_seq(span: Span):
    """Append a residual ``other`` leaf so seq children tile the span."""
    resid = span.dur - sum(c.dur for c in span.children)
    if resid > _EPS:
        span.children.append(Span("other", "slack", resid))


def _layout(span: Span, t0: float):
    """Assign absolute start times: seq children run back to back from
    the parent's start; par children share it."""
    span.t0 = t0
    cursor = t0
    for c in span.children:
        _layout(c, cursor if span.mode == "seq" else t0)
        if span.mode == "seq":
            cursor += c.dur


def lpt_schedule(durations, depth):
    """Reconstruct ``CostModel.engine_makespan``'s LPT schedule.

    Returns ``[(lane, start_offset, dur), ...]`` with
    ``max(start + dur) == engine_makespan(durations)`` bit-exactly —
    same sort, same greedy, same float accumulation order.
    """
    ds = sorted((d for d in durations if d > 0), reverse=True)
    if not ds:
        return []
    if depth == float("inf") or len(ds) <= depth:
        return [(i, 0.0, d) for i, d in enumerate(ds)]
    lanes = [0.0] * max(1, int(depth))
    out = []
    for d in ds:
        i = min(range(len(lanes)), key=lanes.__getitem__)
        out.append((i, lanes[i], d))
        lanes[i] += d
    return out


def components(span: Span, out: dict | None = None) -> dict:
    """Additive decomposition of the max-weight root-to-leaf path.

    seq nodes contribute every child; par nodes contribute their
    longest child plus a named slack term for the serialization floor
    (when the merged duration exceeds the longest branch).  The values
    sum to ``span.dur`` (property-tested to 1e-9).
    """
    if out is None:
        out = {}
    if not span.children:
        out[span.name] = out.get(span.name, 0.0) + span.dur
    elif span.mode == "seq":
        for c in span.children:
            components(c, out)
    else:  # par
        top = max(span.children, key=lambda c: c.dur)
        components(top, out)
        slack = span.dur - top.dur
        if slack > _EPS:
            key = f"{span.name}:slack"
            out[key] = out.get(key, 0.0) + slack
    return out


def path_weight(span: Span) -> float:
    return sum(components(span).values())


class Tracer:
    """Frame-stack request tracer.

    The store pushes a *frame* at every request entry point (including
    requests nested inside other requests — degraded fallbacks, upsert
    delegation, per-proxy lanes); phase/engine hooks append spans to
    the top frame; ``finish`` pops exactly its own frame into a rooted
    request tree.  All hooks no-op when no frame is open, so
    control-plane traffic (fail/restore/checkpoint phases outside any
    request) is dropped rather than misattributed.
    """

    def __init__(self):
        self.requests: list[Span] = []
        self._frames: list[list[Span]] = []
        self._clock = 0.0   # closed-loop virtual timeline

    # -- frames --------------------------------------------------------
    def push(self):
        self._frames.append([])

    def pop(self) -> list[Span]:
        return self._frames.pop() if self._frames else []

    def cancel(self):
        if self._frames:
            self._frames.pop()

    def add(self, span: Span):
        if self._frames:
            self._frames[-1].append(span)

    # -- netsim hooks --------------------------------------------------
    def phase(self, dur: float, leg_costs):
        """Fan-out phase: one leaf per (kind, dst) keeping the max-cost
        representative (the occupying endpoint is in the name)."""
        if not self._frames or dur <= 0.0:
            return
        agg: dict = {}
        for leg, cost in leg_costs:
            key = (leg.kind, leg.dst)
            e = agg.get(key)
            if e is None:
                agg[key] = [cost, leg.src, 1]
            else:
                e[2] += 1
                if cost > e[0]:
                    e[0], e[1] = cost, leg.src
        kids = []
        for (kind, dst), (cost, src, n) in agg.items():
            name = f"{kind}:{src}->{dst}" if dst else f"{kind}:{src}"
            meta = {"src": src, "dst": dst}
            if n > 1:
                meta["n"] = n
            kids.append(Span(name, "link", cost, meta=meta))
        if len(kids) == 1:
            self._frames[-1].append(kids[0])
        else:
            top = max(kids, key=lambda s: s.dur)
            self._frames[-1].append(
                Span(f"fanout:{top.name}", "phase", dur, "par",
                     children=kids))

    def drain(self, dur: float, per_dst: dict, leg_costs):
        """Serialized phase: per destination, inbound legs drain
        sequentially (grouped per kind); destinations run in parallel."""
        if not self._frames or dur <= 0.0:
            return
        groups = []
        for dst, total in per_dst.items():
            kinds: dict = {}
            for leg, cost in leg_costs:
                if leg.dst != dst:
                    continue
                e = kinds.setdefault(leg.kind, [0.0, 0])
                e[0] += cost
                e[1] += 1
            kids = [Span(f"{kind}->{dst}", "link", c,
                         meta={"dst": dst, "n": n})
                    for kind, (c, n) in kinds.items()]
            g = Span(f"drain:{dst}", "phase", total, "seq",
                     children=kids, meta={"dst": dst})
            _fill_seq(g)
            groups.append(g)
        if len(groups) == 1:
            self._frames[-1].append(groups[0])
        else:
            self._frames[-1].append(
                Span("drain", "phase", dur, "par", children=groups))

    def race(self, dur: float, entries):
        """k-of-(k+Δ) race phase: ``entries`` is ``[(name, cost, won)]``
        per candidate round trip.  Winners become link leaves; losers
        become ``cancelled:*`` spans (cat ``cancelled``) clipped to the
        race duration — they show the redundant fetch in the timeline
        but can never be the critical path: winners are listed first,
        and the k-th winner's cost equals the race duration, so the
        par-mode max-child tie-break always lands on a winner.
        """
        if not self._frames or dur <= 0.0:
            return
        winners, losers = [], []
        for name, cost, won in entries:
            if won:
                winners.append(Span(name, "link", cost))
            else:
                losers.append(Span(f"cancelled:{name}", "cancelled",
                                   min(cost, dur),
                                   meta={"cancelled": True,
                                         "full_cost": cost}))
        kids = winners + losers
        if len(kids) == 1:
            self._frames[-1].append(kids[0])
            return
        top = max(winners, key=lambda s: s.dur) if winners else kids[0]
        self._frames[-1].append(
            Span(f"race:{top.name}", "phase", dur, "par", children=kids,
                 meta={"need": len(winners), "dropped": len(losers)}))

    def par(self, name: str, dur: float, segs: list):
        """Wrap spans built in a sub-frame as one parallel composite
        (e.g. the per-key races of one batched coded read)."""
        if not self._frames or not segs:
            return
        if len(segs) == 1 and segs[0].dur == dur:
            self._frames[-1].append(segs[0])
            return
        self._frames[-1].append(Span(name, "phase", dur, "par",
                                     children=segs))

    # -- store hooks ---------------------------------------------------
    def merge_coding(self, coding_s: float, net_s: float, merged: float,
                     kind, lane_durs, depth, async_mode: bool):
        """Replace the just-appended network phase span (if any) with
        the merged coding+network span: par in async mode (dur = max),
        seq otherwise (children tile)."""
        if not self._frames:
            return
        frame = self._frames[-1]
        net_seg = None
        if net_s > 0.0:
            if frame and frame[-1].dur == net_s:
                net_seg = frame.pop()
            else:
                net_seg = Span("net", "phase", net_s)
        eng = None
        if coding_s > 0.0:
            label = f"engine:{kind or 'code'}"
            nz = [d for d in (lane_durs or []) if d > 0]
            if len(nz) > 1:
                kids = []
                for lane, start, d in lpt_schedule(lane_durs, depth):
                    body = Span(label, "engine", d, meta={"lane": lane})
                    if start > 0.0:
                        kids.append(Span(label, "engine", start + d, "seq",
                                         meta={"lane": lane},
                                         children=[
                                             Span("engine:queue", "engine",
                                                  start,
                                                  meta={"lane": lane}),
                                             body]))
                    else:
                        kids.append(body)
                eng = (kids[0] if len(kids) == 1 else
                       Span(f"{label}[{len(kids)}]", "engine", coding_s,
                            "par", children=kids))
            else:
                eng = Span(label, "engine", coding_s)
        kids = [s for s in (eng, net_seg) if s is not None]
        if not kids:
            return
        if len(kids) == 1:
            frame.append(kids[0])
            return
        mode = "par" if async_mode else "seq"
        frame.append(Span(f"merge:{kind or 'code'}", "merge", merged,
                          mode, children=kids))

    def overlap(self, merged: float, branches, async_mode: bool):
        """Two traced branches merged by ``_overlap`` (seal+ack):
        ``branches`` is ``[(name, dur, segs), ...]``."""
        if not self._frames:
            return
        kids = []
        for name, dur, segs in branches:
            if segs and len(segs) == 1 and segs[0].dur == dur:
                kids.append(segs[0])
            else:
                g = Span(name, "group", dur, "seq",
                         children=list(segs or []))
                _fill_seq(g)
                kids.append(g)
        mode = "par" if async_mode else "seq"
        self._frames[-1].append(
            Span("overlap", "merge", merged, mode, children=kids))

    def lanes(self, merged: float, lane_entries, par: bool):
        """Per-proxy lane composite: ``lane_entries`` is
        ``[(proxy_id, dur, segs), ...]``."""
        if not self._frames:
            return
        kids = []
        for pid, dur, segs in lane_entries:
            g = Span(f"lane:p{pid}", "group", dur, "seq",
                     children=list(segs or []), meta={"proxy": pid})
            _fill_seq(g)
            kids.append(g)
        if len(kids) == 1 and kids[0].dur == merged:
            self._frames[-1].append(kids[0])
            return
        self._frames[-1].append(
            Span("lanes", "merge", merged, "par" if par else "seq",
                 children=kids))

    # -- completion ----------------------------------------------------
    def finish(self, kind: str, latency_s: float,
               detail: dict | None = None) -> Span | None:
        """Pop the current frame into a rooted request span.

        Closed loop: the root spans ``[clock, clock + latency)`` on a
        virtual serial timeline.  Event mode (``detail`` from
        ``EventRuntime.submit``): the root spans
        ``[arrival, completion)`` and leads with a ``queued`` par span
        holding the clipped per-resource waits.
        """
        if not self._frames:
            return None
        segs = self._frames.pop()
        meta = {"degraded": kind.endswith("_DEG")}
        if detail is None:
            root = Span(kind, "request", latency_s, "seq",
                        children=segs, meta=meta)
            _fill_seq(root)
            t0 = self._clock
            self._clock += latency_s
        else:
            arrival = detail["arrival"]
            wait = detail["start"] - arrival
            kids = []
            if wait > 0.0:
                wkids = []
                for label, ready in (("admission", detail["admit_ready"]),
                                     ("endpoint", detail["link_ready"]),
                                     ("engine", detail["engine_ready"])):
                    w = min(wait, ready - arrival)
                    if w <= 0.0:
                        continue
                    name = f"wait:{label}"
                    wmeta = {}
                    if label == "endpoint" and detail.get("endpoint"):
                        name = f"wait:endpoint:{detail['endpoint']}"
                        wmeta["endpoint"] = detail["endpoint"]
                    if label == "engine" and detail.get("lane", -1) >= 0:
                        wmeta["lane"] = detail["lane"]
                    wkids.append(Span(name, "wait", w, meta=wmeta))
                kids.append(Span("queued", "wait", wait, "par",
                                 children=wkids))
            svc = Span("service", "group", detail["service"], "seq",
                       children=segs)
            _fill_seq(svc)
            kids.append(svc)
            root = Span(kind, "request", latency_s, "seq",
                        children=kids, meta=meta)
            _fill_seq(root)
            t0 = arrival
        _layout(root, t0)
        self.requests.append(root)
        return root

    # -- reporting -----------------------------------------------------
    def span_count(self) -> int:
        return sum(1 for r in self.requests for _ in r.walk())

    def summary(self) -> dict:
        return {"enabled": True, "requests": len(self.requests),
                "spans": self.span_count(),
                "open_frames": len(self._frames)}

    def reset(self):
        self.requests.clear()
        self._frames.clear()
        self._clock = 0.0


def resolve_trace(trace=None, env: str = "MEMEC_TRACE"):
    """Ctor arg wins; else ``$MEMEC_TRACE``; else off (returns None —
    with tracing off no tracer state is allocated at all)."""
    if isinstance(trace, Tracer):
        return trace
    if trace is None:
        trace = os.environ.get(env, "")
    if isinstance(trace, str):
        trace = trace.strip().lower() not in ("", "0", "false", "off", "no")
    return Tracer() if trace else None


def _cluster_tracers(cluster):
    """``[(pid, name, tracer), ...]`` — facade/unsharded first (pid 0),
    then one pid per shard."""
    tr = getattr(cluster, "tracer", None)
    shards = getattr(cluster, "shards", None)
    if shards is None:
        return [(0, "cluster", tr)] if tr is not None else []
    out = [(0, "facade", tr)] if tr is not None else []
    for si, sh in enumerate(shards):
        if sh.tracer is not None:
            out.append((si + 1, f"shard{si}", sh.tracer))
    return out


# -- critical-path analysis ------------------------------------------------

_PCTS = ((50.0, "p50"), (99.0, "p99"), (99.9, "p999"))


def critical_paths(cluster) -> dict:
    """Per request kind, the additive critical-path decomposition of the
    p50/p99/p999 witness request::

        {"GET": {"count": 812,
                 "p99": {"latency_s": 0.0021,
                         "components": {"get:p0->s5": 0.0013, ...}},
                 ...}, ...}

    Witnesses are nearest-rank order statistics over the traced
    requests, so ``components`` sums to that witness's exact recorded
    latency (the property the tests pin to 1e-9).
    """
    tracers = _cluster_tracers(cluster)
    by_kind: dict[str, list[Span]] = {}
    for _, _, tr in tracers:
        for r in tr.requests:
            by_kind.setdefault(r.name, []).append(r)
    out = {}
    for kind, roots in sorted(by_kind.items()):
        ranked = sorted(roots, key=lambda r: r.dur)
        row: dict = {"count": len(roots)}
        for q, label in _PCTS:
            i = min(len(ranked) - 1,
                    max(0, math.ceil(q / 100.0 * len(ranked)) - 1))
            w = ranked[i]
            comp = components(w)
            row[label] = {
                "latency_s": w.dur,
                "components": dict(sorted(comp.items(),
                                          key=lambda kv: -kv[1])),
            }
        out[kind] = row
    return out


def describe_critical_path(entry: dict, top: int = 3) -> str:
    """Human one-liner: ``"61% get:p0->s5, 24% engine:decode, ..."``."""
    lat = entry["latency_s"]
    if not lat:
        return "0s"
    parts = [f"{100.0 * v / lat:.0f}% {k}"
             for k, v in list(entry["components"].items())[:top]]
    return ", ".join(parts)


# -- Chrome trace-event export ---------------------------------------------

def _tid_label(span: Span) -> str:
    if span.cat == "link":
        return span.meta.get("dst") or span.meta.get("src") or "net"
    if span.cat == "engine":
        lane = span.meta.get("lane")
        return f"engine/lane{lane}" if lane is not None else "engine"
    return "requests"


def export_chrome(cluster, path: str | None = None) -> dict:
    """Chrome trace-event JSON (``ph: "X"`` complete events, µs units):
    one pid per shard (pid 0 = facade/unsharded), one tid per server
    endpoint / engine lane, plus a ``requests`` tid carrying the span
    hierarchy.  Load in Perfetto (ui.perfetto.dev) or about:tracing."""
    events: list[dict] = []
    pid_names: dict[int, str] = {}
    tid_ids: dict[tuple, int] = {}

    def tid_of(pid: int, label: str) -> int:
        key = (pid, label)
        if key not in tid_ids:
            tid_ids[key] = len([k for k in tid_ids if k[0] == pid])
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid_ids[key],
                           "args": {"name": label}})
        return tid_ids[key]

    def emit(span: Span, pid: int):
        if span.cat == "shard":
            pid = int(span.meta.get("shard", 0)) + 1
        ev = {"name": span.name, "cat": span.cat, "ph": "X",
              "pid": pid, "tid": tid_of(pid, _tid_label(span)),
              "ts": span.t0 * 1e6, "dur": max(span.dur, 0.0) * 1e6}
        if span.meta:
            ev["args"] = {k: v for k, v in span.meta.items()}
        events.append(ev)
        for c in span.children:
            emit(c, pid)

    for pid, name, tracer in _cluster_tracers(cluster):
        if pid not in pid_names:
            pid_names[pid] = name
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": name}})
        for root in tracer.requests:
            emit(root, pid)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def validate_chrome(doc: dict) -> dict:
    """Structural guard for the trace-event format; raises ValueError."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("chrome trace: missing traceEvents")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("chrome trace: traceEvents must be a list")
    for ev in evs:
        if not isinstance(ev, dict):
            raise ValueError("chrome trace: event must be a dict")
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"chrome trace: event missing {field!r}")
        if not isinstance(ev["pid"], int) or not isinstance(ev["tid"], int):
            raise ValueError("chrome trace: pid/tid must be ints")
        if ev["ph"] == "X":
            if "ts" not in ev or "dur" not in ev:
                raise ValueError("chrome trace: X event needs ts+dur")
            if ev["dur"] < 0 or ev["ts"] < 0:
                raise ValueError("chrome trace: negative ts/dur")
        elif ev["ph"] != "M":
            raise ValueError(f"chrome trace: unexpected ph {ev['ph']!r}")
    return doc


# -- capture / replay ------------------------------------------------------

class TraceCapture:
    """Arrival timestamps + request kinds of a live open-loop run.

    ``from_cluster`` reads the EventRuntime's event log;
    ``arrival_spec()`` serializes the timestamps back into an
    ``arrival="trace:..."`` spec, so replaying the same workload
    reproduces every arrival — and therefore every queue wait and
    per-kind percentile — deterministically.  ``save``/``load``
    round-trip through JSON (``arrival="trace:@file.json"`` loads one
    directly).
    """

    SCHEMA = "memec/trace-capture"
    VERSION = 1

    def __init__(self, arrivals, kinds=None, inflight: int = 1):
        self.arrivals = [float(t) for t in arrivals]
        self.kinds = list(kinds or [])
        self.inflight = max(1, int(inflight))
        if not self.arrivals:
            raise ValueError("capture needs at least one arrival")

    @classmethod
    def from_cluster(cls, cluster) -> "TraceCapture":
        net = getattr(cluster.net, "local", cluster.net)
        if net.events is None:
            raise ValueError("trace capture needs an open-loop run "
                             "(arrival=poisson/uniform/trace)")
        evs = sorted(net.events.events)   # (seq, kind, arrival, ...)
        return cls([e[2] for e in evs], [e[1] for e in evs],
                   net.arrival.inflight)

    def arrival_spec(self) -> str:
        """An ``arrival=`` spec replaying these arrivals verbatim."""
        ts = ",".join(repr(t) for t in self.arrivals)
        return f"trace:{ts}:inflight={self.inflight}"

    def to_json(self) -> dict:
        return {"schema": self.SCHEMA, "version": self.VERSION,
                "inflight": self.inflight, "arrivals": self.arrivals,
                "kinds": self.kinds}

    @classmethod
    def from_json(cls, doc: dict) -> "TraceCapture":
        if doc.get("schema") != cls.SCHEMA:
            raise ValueError(f"not a trace capture: {doc.get('schema')!r}")
        if doc.get("version") != cls.VERSION:
            raise ValueError(f"trace-capture version {doc.get('version')!r}"
                             f" != {cls.VERSION}")
        return cls(doc["arrivals"], doc.get("kinds"),
                   doc.get("inflight", 1))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path

    @classmethod
    def load(cls, path: str) -> "TraceCapture":
        with open(path) as f:
            return cls.from_json(json.load(f))
