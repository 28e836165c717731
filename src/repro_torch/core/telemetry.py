"""Structured telemetry snapshots for MemEC clusters.

One versioned dict schema for everything an external consumer (the
benchmark harness, ``BENCH_ci.json``, a future dashboard) needs to read
off a running cluster, instead of each caller picking fields out of
``stats`` / ``net`` ad hoc.  The shape is stable under the
``(schema, version)`` pair — add fields freely, bump ``VERSION`` on any
rename/removal so consumers can gate.

Snapshot layout (version 2)::

    {
      "schema":   "memec/telemetry",
      "version":  2,
      "arrival":  {kind, inflight[, rate, seed, trace_len]},
      "open_loop": bool,
      "latency":  {KIND: {count, mean_s, p50_s, p99_s, p999_s
                          [, queue_wait_s, queue_wait_p99_s]}},
      "counters": {...},            # every numeric stats entry
      "engines":  [{engine, path, device_dispatches, modeled_busy_s,
                    ...}, ...],     # one per shard engine
      "trace":    {enabled, requests, spans},  # tracer summary (always)
      "critical_path": {KIND: {count, p50: {latency_s, components},
                               p99: {...}, p999: {...}}},  # {} when off
      "event":    {offered, makespan_s, queue_wait_s,
                   queue_wait_s_by_kind, queue_wait_s_by_resource,
                   arrival},        # open-loop mode only
      "hot_tier": {buffered_updates, flushes, flushed_keys,
                   flushed_versions, saved_parity_rounds,
                   saved_parity_bytes, evictions, barrier_flushes,
                   buffered_keys, tracked_keys}  # only when tier enabled
    }

Version 2 adds the always-present ``trace`` summary and the
``critical_path`` decomposition (populated only when tracing is on —
see ``core/trace.py``).  Version-1 readers gate on ``version`` and fail
loudly in :func:`validate` rather than KeyError-ing on the new shape.

Works duck-typed for both ``MemECCluster`` (``net`` is a ``NetSim``) and
``ShardedCluster`` (``net`` is the ``ShardedNet`` facade view).
"""
from __future__ import annotations

from . import trace as _trace

SCHEMA = "memec/telemetry"
VERSION = 2

#: keys every snapshot must carry, whatever the mode
REQUIRED_KEYS = ("schema", "version", "arrival", "open_loop", "latency",
                 "counters", "engines", "trace", "critical_path")


def snapshot(cluster) -> dict:
    """Versioned telemetry snapshot of a cluster (sharded or not)."""
    net = cluster.net
    stats = cluster.stats
    engines = getattr(cluster, "engines", None) or [cluster.engine]
    snap = {
        "schema": SCHEMA,
        "version": VERSION,
        "arrival": net.arrival.describe(),
        "open_loop": net.events is not None,
        "latency": net.latency_summary(),
        "counters": {k: v for k, v in stats.items()
                     if isinstance(v, (int, float))},
        "engines": [dict(e.stats(), engine=e.name) for e in engines],
    }
    # hot-key tier (optional — present only when the tier is enabled;
    # additive field, so the schema stays at version 2)
    if "hot_tier" in stats:
        snap["hot_tier"] = dict(stats["hot_tier"])
    tracers = _trace._cluster_tracers(cluster)
    if tracers:
        snap["trace"] = {
            "enabled": True,
            "requests": sum(len(tr.requests) for _, _, tr in tracers),
            "spans": sum(tr.span_count() for _, _, tr in tracers),
        }
        snap["critical_path"] = _trace.critical_paths(cluster)
    else:
        snap["trace"] = {"enabled": False, "requests": 0, "spans": 0}
        snap["critical_path"] = {}
    if net.events is not None:
        snap["event"] = net.events.snapshot()
    return snap


def validate(snap: dict) -> dict:
    """Assert ``snap`` is a consumable version-2 snapshot; returns it.

    Consumers (benchmarks/common.py, the verify.sh CI smoke) call this
    before reading fields so a schema drift fails loudly at the seam
    instead of as a KeyError three layers down.  Version-1 snapshots are
    rejected here by the version gate.
    """
    if snap.get("schema") != SCHEMA:
        raise ValueError(f"not a {SCHEMA} snapshot: {snap.get('schema')!r}")
    if snap.get("version") != VERSION:
        raise ValueError(f"telemetry version {snap.get('version')!r} != "
                         f"supported {VERSION}")
    missing = [k for k in REQUIRED_KEYS if k not in snap]
    if missing:
        raise ValueError(f"telemetry snapshot missing keys: {missing}")
    if snap["open_loop"] and "event" not in snap:
        raise ValueError("open-loop snapshot without an 'event' section")
    for kind, s in snap["latency"].items():
        for field in ("count", "mean_s", "p50_s", "p99_s", "p999_s"):
            if field not in s:
                raise ValueError(f"latency[{kind!r}] missing {field}")
    tr = snap["trace"]
    for field in ("enabled", "requests", "spans"):
        if field not in tr:
            raise ValueError(f"trace summary missing {field}")
    if not tr["enabled"] and snap["critical_path"]:
        raise ValueError("critical_path populated with tracing disabled")
    for kind, row in snap["critical_path"].items():
        for field in ("count", "p50", "p99", "p999"):
            if field not in row:
                raise ValueError(f"critical_path[{kind!r}] missing {field}")
    return snap
