"""The port's scale-out layer against the JAX package's.

Twin sharded clusters: the reference ``make_cluster`` on its numpy engine
and the port's on ``cuda:cpu`` (the CUDA engine's CPU dispatch, i.e. the
kernels' plain versions), ``torch:cpu`` and a mixed ``cuda:cpu,numpy``
spec get the same seeded traffic, degraded decodes, a failure isolated to
one shard, ring ``add_shard``/``remove_shard``/``rebalance`` with every
key read back at every migration step, and span tracing on.  Contents,
``stats``, every report, the Chrome trace export, ``critical_paths()``
and the telemetry snapshot (apart from its engine-provenance list) must
be equal.  Also: ``engine_specs``, S = 1, Δ = 1 straggler reads, the
baselines and analysis formulas, and the port's quickstart on the CPU.
Tolerance: exact equality (the runtime is deterministic and latencies are
modeled from work bytes).
"""
import contextlib
import io

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import analysis as ref_analysis
from repro.data import ycsb as ref_ycsb
import repro_torch.core as core
from repro_torch.core import analysis
from repro_torch.core.engine import CudaEngine, NumpyEngine, TorchEngine
from repro_torch.data import ycsb
from test_torch_cluster import parity_invariant

torch.set_num_threads(1)

KW = dict(num_servers=10, num_proxies=2, scheme="rs", n=4, k=2, c=8,
          chunk_size=256, max_unsealed=2)

PORT = (core, ycsb)
REF = (ref_core, ref_ycsb)


def seeded_items(n, seed=0, sizes=(8, 32)):
    rng = np.random.default_rng(seed)
    return [(b"sk%06d" % i,
             bytes(rng.integers(0, 256, sizes[i % len(sizes)],
                                dtype=np.uint8)))
            for i in range(n)]


# ---------------------------------------------------------------------------
# engine specs and construction
# ---------------------------------------------------------------------------

SPEC_CASES = [("numpy", 3), ("torch,numpy", 4), (["cuda"], 3),
              (("numpy", "torch:cpu"), 5), ("cuda:cpu,numpy", 4),
              (" cuda:cpu , numpy ,", 3)]


@pytest.mark.parametrize("spec,shards", SPEC_CASES)
def test_engine_specs_cycle_as_the_reference(spec, shards, monkeypatch):
    monkeypatch.delenv("MEMEC_ENGINE", raising=False)
    monkeypatch.delenv("MEMEC_TORCH_ENGINE", raising=False)
    assert core.engine_specs(spec, shards) == \
        ref_core.engine_specs(spec, shards)


def test_engine_specs_read_the_port_knob_only(monkeypatch):
    monkeypatch.setenv("MEMEC_ENGINE", "pallas")
    monkeypatch.delenv("MEMEC_TORCH_ENGINE", raising=False)
    assert core.engine_specs(None, 2) == [None, None]
    monkeypatch.setenv("MEMEC_TORCH_ENGINE", "cuda:cpu,numpy")
    assert core.engine_specs(None, 3) == ["cuda:cpu", "numpy", "cuda:cpu"]
    with pytest.raises(ValueError):
        core.engine_specs([], 2)
    eng = NumpyEngine(core.make_code("rs", 4, 2))
    assert core.engine_specs(eng, 2) == [eng, eng]
    # engine=None on a sharded cluster resolves through the port's knob
    cl = core.make_cluster(shards=3, **KW)
    kinds = [type(e) for e in cl.engines]
    assert kinds == [CudaEngine, NumpyEngine, CudaEngine]
    assert all(e.device.type == "cpu" for e in cl.engines[::2])


def test_mixed_engines_per_shard(monkeypatch):
    monkeypatch.delenv("MEMEC_TORCH_ENGINE", raising=False)
    cl = core.make_cluster(shards=3, engine="torch:cpu,numpy,cuda:cpu", **KW)
    assert [type(e) for e in cl.engines] == [TorchEngine, NumpyEngine,
                                             CudaEngine]
    items = seeded_items(120, seed=5)
    assert all(cl.multi_set(items))
    assert cl.multi_get([k for k, _ in items]) == [v for _, v in items]


def test_s1_is_the_plain_cluster():
    cl = core.make_cluster(shards=1, engine="cuda:cpu", **KW)
    assert type(cl) is core.MemECCluster
    assert isinstance(cl.engine, CudaEngine)
    cl3 = core.make_cluster(shards=3, engine="cuda:cpu", **KW)
    assert isinstance(cl3, core.ShardedCluster) and cl3.num_shards == 3


def test_configured_cluster_shards_through_make_cluster():
    from dataclasses import replace

    from repro_torch.configs.memec import CONFIG, make_configured_cluster
    assert (CONFIG.shards, CONFIG.placement, CONFIG.batch_size) == \
        (1, None, 1)
    assert type(make_configured_cluster(CONFIG, engine="numpy")) is \
        core.MemECCluster
    cl = make_configured_cluster(
        replace(CONFIG, shards=2, placement="ring", batch_size=64),
        engine="cuda:cpu")
    assert isinstance(cl, core.ShardedCluster) and cl.num_shards == 2
    assert cl.placement.kind == "ring"
    assert (cl.n, cl.k, cl.chunk_size, cl.servers_per_shard) == \
        (CONFIG.n, CONFIG.k, CONFIG.chunk_size, CONFIG.num_servers)


# ---------------------------------------------------------------------------
# twin scenario: traffic, failures, migration, tracing
# ---------------------------------------------------------------------------

def sealed(sh):
    return sum(int(sum(bool(x) for x in s.sealed)) for s in sh.servers)


def victim(sh):
    """The server of a shard holding the most sealed data chunks."""
    def count(srv):
        return sum(1 for idx, cid in enumerate(srv.chunk_ids)
                   if cid is not None and srv.sealed[idx]
                   and cid.position < sh.k)
    return max(range(len(sh.servers)), key=lambda s: count(sh.servers[s]))


def scenario(pkg, shards, engine):
    """One seeded run through the sharded API of ``pkg``; returns what
    the twins must agree on and the cluster."""
    cmod, ymod = pkg
    cl = cmod.make_cluster(shards=shards, placement="ring", engine=engine,
                           trace=True, **KW)
    out = {}
    items = seeded_items(700, seed=shards)
    for i in range(0, len(items), 32):
        assert all(cl.multi_set(items[i:i + 32]))
    cfg = ymod.YCSBConfig(num_objects=500)
    ymod.run_workload(cl, "load", 0, cfg, batch_size=16)
    ymod.run_workload(cl, "A", 600, cfg, batch_size=16)
    w = ymod.YCSBWorkload(cfg)
    keys = [k for k, _ in items] + [w.key(i) for i in range(500)]
    out["sealed"] = [sealed(sh) for sh in cl.shards]

    # degraded decode in the shard with the most sealed chunks; the
    # failure must leave every other shard's state untouched
    si = max(range(shards), key=lambda i: out["sealed"][i])
    sid = victim(cl.shards[si])
    others = [sh for j, sh in enumerate(cl.shards) if j != si]
    before = [sh.stats for sh in others]
    out["fail_deg"] = cl.fail_server(sid, shard=si, recover=False)
    assert [sh.stats for sh in others] == before
    out["degraded_reads"] = cl.multi_get(keys)
    assert cl.failed == {cl.global_sid(si, sid)}
    assert cl.shards[si].stats["degraded_requests"] > 0
    assert all(sh.stats["degraded_requests"] == 0 and not sh.failed
               for sh in others)
    out["restore_deg"] = cl.restore_server(cl.global_sid(si, sid))
    out["fail"] = cl.fail_server(sid, shard=si)
    cl.multi_update([(k, v[::-1]) for k, v in items[:64]])
    out["restore"] = cl.restore_server(sid, shard=si)

    # live migration: every key readable at every batch boundary
    steps = []

    def cb(progress):
        steps.append(progress["batch"])
        assert cl.multi_get(keys) == want

    want = cl.multi_get(keys)
    out["add_shard"] = cl.add_shard(batch_size=48, step_cb=cb)
    out["remove_shard"] = cl.remove_shard(1, batch_size=48, step_cb=cb)
    cl.reset_load()
    hot = [k for k in keys if cl.shard_of(k) == 0][:200]
    for _ in range(4):
        cl.multi_get(hot)
    out["rebalance"] = cl.rebalance(skew_threshold=1.2, batch_size=48,
                                    step_cb=cb)
    out["steps"] = steps
    out["stats"] = cl.stats
    out["contents"] = cl.multi_get(keys)
    out["chrome"] = cmod.trace.export_chrome(cl)
    out["critical"] = cmod.trace.critical_paths(cl)
    snap = cmod.telemetry.validate(cmod.telemetry.snapshot(cl))
    out["engines"] = snap.pop("engines")
    out["telemetry"] = snap
    return out, cl


@pytest.fixture(scope="module")
def reference_runs():
    cache = {}

    def get(shards):
        if shards not in cache:
            cache[shards] = scenario(REF, shards, "numpy")[0]
        return cache[shards]
    return get


@pytest.mark.parametrize("shards,engine", [(3, "cuda:cpu"),
                                           (4, "cuda:cpu,numpy"),
                                           (4, "torch:cpu")])
def test_twin_sharded_cluster_matches_reference(reference_runs, shards,
                                                engine):
    ref = reference_runs(shards)
    got, cl = scenario(PORT, shards, engine)
    assert all(n > 0 for n in got["sealed"]), got["sealed"]
    assert got["fail"]["recovered_chunks"] > 0
    assert got["add_shard"]["moved_keys"] > 0 and len(got["steps"]) > 2
    assert got["rebalance"]["moved_keys"] > 0
    assert all(v is not None for v in got["contents"])
    assert got["stats"]["degraded_requests"] > 0
    for key in ("sealed", "fail_deg", "degraded_reads", "restore_deg",
                "fail", "restore", "add_shard", "remove_shard", "rebalance",
                "steps", "stats", "contents", "chrome", "critical",
                "telemetry"):
        assert got[key] == ref[key], f"{key} differs from the reference"
    # engine provenance is the one expected difference
    assert [e["engine"] for e in got["engines"]] == \
        [type(e).name for e in cl.engines]
    for sh in cl.shards:
        _, bad = parity_invariant(sh)
        assert bad == 0
    want = {"torch": "torch-plain", "cuda": "torch-cpu"}
    for eng in cl.engines:
        if eng.name != "numpy":
            assert set(eng.op_paths.values()) <= {want[eng.name]}
            assert eng.op_paths, f"{eng.name} shard ran no coding op"


def straggler_run(pkg, engine):
    cmod, _ = pkg
    cl = cmod.make_cluster(shards=3, engine=engine, redundant_reads=1,
                           arrival="poisson:3000:seed=3:inflight=4",
                           trace=True, **KW)
    items = seeded_items(600, seed=9)
    for i in range(0, len(items), 32):
        cl.multi_set(items[i:i + 32])
    cl.inflate_server(2, 10.0, shard=1)
    keys = [k for k, _ in items]
    got = cl.multi_get(keys) + [cl.get(k) for k in keys[::5]]
    return {"got": got, "stats": cl.stats,
            "critical": cmod.trace.critical_paths(cl)}


def test_straggler_reads_match_reference():
    got = straggler_run(PORT, "cuda:cpu")
    ref = straggler_run(REF, "numpy")
    assert got["stats"]["redundant_cancelled"] > 0
    assert got == ref


# ---------------------------------------------------------------------------
# baselines, analysis, telemetry of one shard, the quickstart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["AllReplicationCluster",
                                   "HybridEncodingCluster"])
def test_baselines_match_reference(model):
    kw = dict(num_servers=16, n=10, k=8)
    if model == "HybridEncodingCluster":
        kw.update(scheme="rs", chunk_size=512)

    def run(pkg):
        cmod, ymod = pkg
        cl = getattr(cmod, model)(**kw)
        cfg = ymod.YCSBConfig(num_objects=600)
        ymod.run_workload(cl, "load", 0, cfg)
        ymod.run_workload(cl, "A", 500, cfg)
        cl.fail_server(3)
        w = ymod.YCSBWorkload(cfg)
        vals = [cl.get(w.key(i)) for i in range(0, 600, 7)]
        cl.restore_server(3)
        return vals, cl.total_memory(), cl.net.snapshot()
    assert run(PORT) == run(REF)


def test_analysis_matches_reference():
    for nk in ((10, 8), (14, 10), (4, 2)):
        for K in (8, 24, 64):
            assert analysis.figure2_table(K, nk) == \
                ref_analysis.figure2_table(K, nk)
            assert analysis.crossover_value(K, nk, 1.5) == \
                ref_analysis.crossover_value(K, nk, 1.5)

    class Compiled:
        def cost_analysis(self):
            return [{"flops": 3.0}]
    assert analysis.xla_cost_analysis(Compiled()) == {"flops": 3.0}


def test_telemetry_snapshot_of_one_shard_validates():
    cl = core.make_cluster(shards=1, engine="cuda:cpu", trace=True, **KW)
    for k, v in seeded_items(300):
        cl.set(k, v)
    snap = core.telemetry.validate(core.telemetry.snapshot(cl))
    assert snap["engines"][0]["engine"] == "cuda"
    assert snap["trace"]["enabled"] and snap["critical_path"]


def test_quickstart_runs_on_the_cpu():
    from repro_torch import quickstart
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        quickstart.main(["--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "cluster: 16 servers, RS(10,8), 16 stripe lists"
    assert lines[-1].startswith(
        "kernel encode + decode-from-8-of-10 round trip: OK")
    assert "'path': 'torch-cpu'" in lines[-1]
