"""Quickstart: the MemEC store + the coding kernels in five minutes.

The port's twin of the JAX package's ``examples/quickstart.py``: the same
sections, asserts and printed quantities, on the hand-written CUDA
kernels.  It runs on the card by default; ``--device cpu`` runs every
cluster on ``engine="cuda:cpu"`` (the kernels' plain versions) and
section 4 on CPU tensors.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import MemECCluster, make_cluster
from repro_torch.core.codes import RSCode
from repro_torch.kernels import dispatch, ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the coding kernels run (default: the card)")
    args = ap.parse_args(argv)
    device = dispatch.resolve_device(args.device)
    # every cluster's coding engine: the CUDA kernels, or their plain
    # versions on the CPU
    engine = "cuda" if device.type == "cuda" else "cuda:cpu"

    # --- 1. an erasure-coded in-memory KV cluster (paper §4) ---
    cluster = MemECCluster(engine=engine, num_servers=16, scheme="rs", n=10,
                           k=8, c=16, chunk_size=512, max_unsealed=2)
    print("cluster: 16 servers, RS(10,8), 16 stripe lists")
    rng = np.random.default_rng(0)
    for i in range(3000):
        cluster.set(b"user%08d" % i, rng.bytes(24))
    print("loaded 3000 objects;",
          sum(s.seals for s in cluster.servers), "chunks sealed+encoded")

    cluster.update(b"user%08d" % 7, b"B" * 24)         # delta parity update
    print("GET after UPDATE:", cluster.get(b"user%08d" % 7)[:8], "...")

    # --- 2. kill a server; reads keep working (degraded mode, §5) ---
    t = cluster.fail_server(3)
    print(f"server 3 failed; transition T_N->D = {t['T_N_to_D']*1e3:.2f} ms")
    v = cluster.get(b"user%08d" % 7)
    assert v is not None
    print("degraded GET served;",
          cluster.stats["reconstructions"], "chunks reconstructed on demand")
    t = cluster.restore_server(3)
    print(f"server 3 restored; T_D->N = {t['T_D_to_N']*1e3:.2f} ms")

    # --- 3. scale out: sharded cluster, pipelined cross-shard batches ---
    sc = make_cluster(shards=4, engine=engine, num_servers=16, scheme="rs",
                      n=10, k=8, c=4, chunk_size=512, max_unsealed=1)
    items = [(b"batch%07d" % i, rng.bytes(24)) for i in range(6000)]
    for i in range(0, len(items), 64):
        sc.multi_set(items[i:i + 64])       # scatter/gather across shards
    got = sc.multi_get([k for k, _ in items[:64]])
    assert got == [v for _, v in items[:64]]
    print(f"sharded x4: {sc.stats['pipelined_batches']} pipelined batches, "
          f"{sc.stats['pipeline_overlap_saved_s']*1e3:.1f} modeled ms saved "
          "by overlapping shards")
    # fail a chunk-owning server in shard 2 only; others stay untouched
    victim = max(range(16),
                 key=lambda s: sum(sc.shards[2].servers[s].sealed))
    t = sc.fail_server(victim, shard=2)
    print(f"shard {t['shard']} recovered {t['recovered_chunks']} chunks in "
          f"{t['T_recovery']*1e3:.2f} modeled ms; "
          "other shards stayed decentralized")
    sc.restore_server(victim, shard=2)

    # --- 3a. async pipeline: hide coding behind the network ---
    # coding now has a modeled cost; async_engine=True submits engine
    # work as futures while netsim legs are in flight (max(coding, net)
    # per phase), overlaps seal fan-out with SET acks, and spreads
    # multi-key batches across proxies — contents stay byte-identical
    pair = {}
    for mode in (False, True):
        cl2 = make_cluster(shards=1, engine=engine, num_servers=16,
                           scheme="rs", n=10, k=8, c=4, chunk_size=512,
                           max_unsealed=2, async_engine=mode)
        for i in range(0, 3000, 64):
            cl2.multi_set(items[i:i + 64], proxy_id=None)
        pair[mode] = cl2
    assert (pair[True].multi_get([k for k, _ in items[:64]])
            == pair[False].multi_get([k for k, _ in items[:64]]))
    print(f"async S=1: saved "
          f"{pair[True].stats['intra_overlap_saved_s']*1e3:.1f} modeled ms "
          f"vs sync (coding {pair[True].stats['modeled_coding_s']*1e3:.1f} "
          f"ms hidden behind legs/acks), plus "
          f"{pair[True].stats['proxy_lane_saved_s']*1e3:.1f} ms vs serial "
          f"per-proxy calls across "
          f"{pair[True].stats['proxy_lane_batches']} lane batches; "
          "contents byte-identical to sync")

    # --- 3a'. plan/execute decode + the modeled engine queue ---
    # decode is a DecodePlan (host metadata: pattern group-by, cached
    # inversions) plus one batched device matmul per pattern group, so
    # the device engines launch it at submit; in async mode degraded
    # reconstruction overlaps decode with the recon fetches — the win is
    # stats["decode_overlap_saved_s"].  CostModel(engine_depth=d) bounds
    # how many engine calls one shard runs concurrently (default inf =
    # the historical no-contention merge); the extra wait a finite depth
    # induces lands in stats["engine_queue_wait_s"].
    from repro_torch.core import CostModel
    deg = {}
    for depth in (float("inf"), 1):
        cl3 = make_cluster(shards=1, engine=engine, num_servers=16,
                           scheme="rs", n=10, k=8, c=4, chunk_size=512,
                           max_unsealed=2, num_proxies=1, async_engine=True,
                           cost=CostModel(coding_Bps=5e7,
                                          coding_fixed_s=2e-5,
                                          engine_depth=depth))
        for i in range(0, 2000, 32):
            cl3.multi_set(items[i:i + 32])
        cl3.fail_server(3, recover=False)   # §5.4 on-demand reconstruction
        cl3.multi_get([k for k, _ in items[:400]])
        deg[depth] = cl3
    inf_cl, d1 = deg[float("inf")], deg[1]
    print(f"eager decode: {inf_cl.stats['reconstructions']} on-demand "
          f"recons hid {inf_cl.stats['decode_overlap_saved_s']*1e3:.2f} "
          "modeled ms of decode behind recon fetches; "
          f"engine_depth=1 adds {d1.stats['engine_queue_wait_s']*1e3:.2f} "
          "ms of modeled queue wait (depth=inf adds "
          f"{inf_cl.stats['engine_queue_wait_s']*1e3:.2f})")

    # --- 3b. elastic placement: grow the cluster + escape a hot shard ---
    ec = make_cluster(shards=3, placement="ring", engine=engine,
                      num_servers=16, scheme="rs", n=10, k=8, c=4,
                      chunk_size=512, max_unsealed=1)
    items = [(b"el%07d" % i, rng.bytes(24)) for i in range(4000)]
    for i in range(0, len(items), 64):
        ec.multi_set(items[i:i + 64])
    rep = ec.add_shard()                    # live migration, ~1/S of keys
    print(f"add_shard: moved {rep['moved_keys']} keys "
          f"({rep['moved_bytes']} B, {rep['move_fraction']:.0%} of "
          "residents) — consistent hashing, not a reshuffle")
    ec.reset_load()
    hot = [k for k, _ in items if ec.shard_of(k) == 0][:400]
    for _ in range(4):
        ec.multi_get(hot)                   # hammer shard 0
    print(f"load skew before rebalance: {ec.load_skew():.2f} "
          f"(shard ops {ec.stats['shard_ops']})")
    rep = ec.rebalance(skew_threshold=1.2)  # shed the hot shard's arcs
    for _ in range(4):
        ec.multi_get(hot)
    print(f"rebalance moved {rep['moved_keys']} keys; "
          f"skew after: {ec.load_skew():.2f}")
    assert ec.multi_get([k for k, _ in items[:64]]) == \
        [v for _, v in items[:64]]          # nothing lost along the way

    # --- 3c. open-loop arrivals + tail percentiles ---
    # the phase algebra prices each request in isolation; an open-loop
    # ArrivalProcess (arrival= / $MEMEC_ARRIVAL) turns every recorded
    # request into a discrete event contending FCFS for admission slots,
    # per-endpoint link clocks, and CostModel.engine_depth coding lanes,
    # so p50/p99/p999 in stats["latency"] include queue wait.  Specs:
    #   MEMEC_ARRIVAL=poisson:5000:seed=1:inflight=4   seeded Poisson
    #   MEMEC_ARRIVAL=uniform:2000                     fixed 1/rate gaps
    #   MEMEC_ARRIVAL=trace:0.001,0.003,0.0035         explicit arrivals
    # The default "closed" keeps the historical closed loop (no event
    # machinery; rate->inf with inflight=1 reproduces it exactly), and
    # repro_torch.core.telemetry.snapshot() exports the versioned dict
    # schema that benchmark harnesses consume.
    from repro_torch.core import telemetry
    ol = MemECCluster(engine=engine, num_servers=16, scheme="rs", n=10, k=8,
                      c=16, chunk_size=512, max_unsealed=2,
                      arrival="poisson:2500:seed=1:inflight=4")
    for i in range(2000):
        ol.set(b"tail%06d" % i, rng.bytes(24))
    for i in range(4000):
        ol.get(b"tail%06d" % (i % 2000))
    lat = ol.stats["latency"]["GET"]
    snap = telemetry.validate(telemetry.snapshot(ol))
    print(f"open loop (poisson, inflight=4): GET p50 "
          f"{lat['p50_s']*1e3:.3f} ms, p99 {lat['p99_s']*1e3:.3f} ms, "
          f"p999 {lat['p999_s']*1e3:.3f} ms; queue wait "
          f"{ol.stats['queue_wait_s']*1e3:.1f} modeled ms "
          f"(telemetry schema {snap['schema']} v{snap['version']})")

    # --- 3d. span tracing + critical-path attribution ---
    # a bad p99 is opaque until you can see WHICH leg was slow.  With
    # trace=True (or MEMEC_TRACE=1) every recorded request grows a span
    # tree — admission wait, per-endpoint link legs, engine-lane queue +
    # service, seal/delta/decode phases tagged normal vs degraded — whose
    # max-weight root-to-leaf path equals the recorded latency.  Off by
    # default and zero-cost when off (no tracer state is allocated).
    #   trace.critical_paths(cl)  decomposes the p50/p99/p999 witness per
    #                             request kind into additive components
    #                             (telemetry v2 "critical_path" section)
    #   trace.export_chrome(cl, path="trace.json")  writes Chrome
    #                             trace-event JSON — open in Perfetto
    #                             (ui.perfetto.dev), one pid per shard,
    #                             one tid per server link / engine lane
    #   TraceCapture.from_cluster(cl)  records the run's arrivals + kinds;
    #                             replay it deterministically with
    #                             arrival=cap.arrival_spec() (or save()
    #                             and arrival="trace:@capture.json") to
    #                             reproduce a tail incident exactly
    from repro_torch.core import TraceCapture, trace
    tr = MemECCluster(engine=engine, num_servers=16, scheme="rs", n=10, k=8,
                      c=16, chunk_size=512, max_unsealed=2,
                      arrival="poisson:2500:seed=1:inflight=4", trace=True)
    for i in range(400):
        tr.set(b"sp%06d" % i, rng.bytes(24))
    for i in range(800):
        tr.get(b"sp%06d" % (i % 400))
    cp = trace.critical_paths(tr)["GET"]["p99"]
    top, share = max(cp["components"].items(), key=lambda kv: kv[1]), \
        cp["latency_s"]
    print(f"GET p99 critical path: {top[0]} = {top[1]/share:.0%} of "
          f"{share*1e3:.3f} ms ({len(cp['components'])} components)")
    cap = TraceCapture.from_cluster(tr)
    print(f"captured {len(cap.arrivals)} arrivals; replay with "
          f"arrival=cap.arrival_spec() for a deterministic re-run")

    # --- 3e. straggler-tolerant reads: k-of-(k+Δ) + slow servers ---
    # one slow server ruins p99 for every read that touches it.  With
    # redundant_reads=Δ (or MEMEC_REDUNDANT_READS=Δ) a GET fans out to
    # the k-1+Δ least-loaded other stripe members alongside the data
    # server and completes at the k-th arrival; if the data server is
    # among the dropped Δ, the winners' chunks decode the value instead
    # (byte-identical, guarded by tests).  Dropped legs still occupy
    # links — later requests queue behind them — but show up as
    # cancelled spans, never on the critical path.  Inject a straggler
    # with inflate_server(sid, factor) (factor=1.0 restores):
    st = {}
    for delta in (0, 1):
        s = MemECCluster(engine=engine, num_servers=16, scheme="rs", n=10,
                         k=8, c=4, chunk_size=512, max_unsealed=2,
                         redundant_reads=delta)
        for i in range(1400):
            s.set(b"st%06d" % i, rng.bytes(24))
        s.inflate_server(3, 10.0)          # one server suddenly 10x slower
        for i in range(1400):
            s.get(b"st%06d" % i)
        st[delta] = s.stats["latency"]["GET"]["p99_s"] * 1e3
        if delta:
            print(f"straggler hidden: GET p99 {st[0]:.3f} -> {st[1]:.3f} ms "
                  f"({s.stats['redundant_decodes']} redundant decodes, "
                  f"{s.stats['redundant_cancelled']} cancelled fetches)")

    # --- 3f. hot-key update tier: version-buffered delta coding ---
    # every sealed UPDATE pays an engine delta + m parity legs; under a
    # Zipf write mix the few hottest keys dominate that cost.  With
    # hot_key_threshold=t (or MEMEC_HOT_KEYS=t) an EWMA tracker marks
    # sustained updaters hot and buffers their per-update XOR deltas
    # (bounded by hot_max_keys / hot_max_versions); data-server bytes
    # stay current — only parity lags, and only while buffered.  A flush
    # (eviction, a full entry, any parity-reading path: redundant-read
    # races, fail_server — or the explicit flush_hot_buffers()) folds
    # each key's V versions into ONE engine.submit_delta_collapse round,
    # so N buffered updates cost one parity round and the delta legs
    # carry just the union byte extent.  Byte-identical to a tier-off
    # twin (guarded by tests/test_hot_tier.py); stats land under
    # stats["hot_tier"] and the telemetry snapshot's "hot_tier" key:
    hot = MemECCluster(engine=engine, num_servers=16, scheme="rs", n=10,
                       k=8, c=4, chunk_size=512, max_unsealed=2,
                       hot_key_threshold=3.0)
    for i in range(1200):
        hot.set(b"hk%06d" % i, rng.bytes(64))
    for rep in range(200):
        hot.update(b"hk%06d" % (rep % 3), rng.bytes(64))
    folded = hot.flush_hot_buffers()
    ht = hot.stats["hot_tier"]
    print(f"hot tier: {ht['buffered_updates']} updates buffered, "
          f"{ht['saved_parity_rounds']} parity rounds saved "
          f"({ht['saved_parity_bytes']} delta bytes), "
          f"{folded} entries folded at the explicit drain")

    # --- 4. the GF(2^8) data plane on the hand-written kernels ---
    # kernels/dispatch decides per call from where the data lies: a
    # tensor on the card launches the CUDA kernel, a CPU tensor runs the
    # kernel's plain torch version.  No flag or environment variable
    # sends card tensors anywhere else; `engine.describe()` /
    # `engine.stats()["op_paths"]` report the path each op took, so a
    # run can always answer "did the kernels run?".
    code = RSCode(n=10, k=8)
    data = torch.from_numpy(
        rng.integers(0, 256, (8, 4096), dtype=np.uint8)).to(device)
    parity = ops.encode_stripe(code, data)           # dispatched kernel
    stripe = torch.cat([data, parity])
    rec = ops.decode_stripe(code, {i: stripe[i] for i in range(10)
                                   if i not in (1, 9)}, [1, 9], 4096)
    assert torch.equal(rec[1], stripe[1]) and torch.equal(rec[9], stripe[9])
    print(f"kernel encode + decode-from-8-of-10 round trip: OK "
          f"(dispatch: {dispatch.describe(data)})")

if __name__ == "__main__":
    main()
