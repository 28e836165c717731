"""Twin clusters: the port's MemECCluster against the JAX package's.

The reference cluster runs on its numpy engine; the port's runs on its
plain torch engine (``torch:cpu``) and on ``CudaEngine`` with
``device="cpu"`` (the kernel wrappers' CPU dispatch).  Both get the same
YCSB load and workload A in batches, a data-server fail/restore and a
parity-server fail/restore.  Every key must read back the same bytes,
``stats`` must be equal, the raw chunk bytes of every server must be
equal, and the parity sweep must find no stale parity.
"""
import numpy as np
import pytest
import torch

from repro.core import MemECCluster as RefCluster
from repro.data.ycsb import YCSBConfig as RefYCSBConfig
from repro.data.ycsb import run_workload as ref_run_workload
from repro_torch.core import CudaEngine, MemECCluster, make_code
from repro_torch.core.chunk import ChunkId
from repro_torch.data.ycsb import YCSBConfig, YCSBWorkload, run_workload

torch.set_num_threads(1)

KW = dict(num_servers=16, scheme="rs", n=10, k=8, c=16, chunk_size=512,
          max_unsealed=1)
N_OBJ = 3000
BATCH = 16


def parity_invariant(cl):
    """Every sealed data chunk must decode from the other stripe chunks
    (the port's copy of ``tests/test_store.py::parity_invariant``)."""
    bad = checked = 0
    cs = cl.chunk_size
    for s in cl.servers:
        for idx, cid in enumerate(s.chunk_ids):
            if cid is None or not s.sealed[idx] or cid.position >= cl.k:
                continue
            sl = cl.stripe_lists[cid.stripe_list_id]
            avail = {}
            for i in range(cl.n):
                if i == cid.position:
                    continue
                owner = sl.servers[i]
                c = cl.servers[owner].get_sealed_chunk(
                    ChunkId(cid.stripe_list_id, cid.stripe_id, i))
                avail[i] = c if c is not None else np.zeros(cs, np.uint8)
            rec = cl.code.decode(avail, [cid.position], cs)[cid.position]
            checked += 1
            bad += 0 if np.array_equal(rec, s.region[idx]) else 1
    return checked, bad


def victim(cl, parity_side):
    """The server holding the most sealed data (or parity) chunks."""
    def count(srv):
        return sum(1 for idx, cid in enumerate(srv.chunk_ids)
                   if cid is not None and srv.sealed[idx]
                   and (cid.position >= cl.k) == parity_side)
    sid = max(range(len(cl.servers)), key=lambda s: count(cl.servers[s]))
    assert count(cl.servers[sid]) > 0
    return sid


def scenario(cl, cfg, run):
    """load -> A -> fail data server -> A -> restore -> fail parity
    server -> A -> restore.  Returns what the transitions reported."""
    run(cl, "load", 0, cfg, batch_size=BATCH)
    run(cl, "A", 1500, cfg, batch_size=BATCH)
    out = []
    for parity_side in (False, True):
        sid = victim(cl, parity_side)
        out.append((sid, cl.fail_server(sid)))
        run(cl, "A", 600, cfg, batch_size=BATCH)
        out.append((sid, cl.restore_server(sid)))
    if cl.hot is not None:
        cl.flush_hot_buffers()
    return out


def regions(cl):
    return [bytes(np.asarray(c)) for srv in cl.servers for c in srv.region]


def contents(cl):
    w = YCSBWorkload(YCSBConfig(num_objects=N_OBJ))
    return cl.multi_get([w.key(i) for i in range(N_OBJ)])


def snapshot(cl, trans):
    """What the twins must agree on; ``stats`` is read before the
    contents sweep, whose reads add to the latency records."""
    stats = cl.stats
    return {"transitions": trans, "stats": stats, "contents": contents(cl),
            "regions": regions(cl)}


def port_engine(kind):
    if kind == "cuda-on-cpu":
        return CudaEngine(make_code("rs", 10, 8), device="cpu")
    return kind


@pytest.fixture(scope="module")
def reference_runs():
    """The reference cluster's end-state snapshot per (async, hot)
    setting, built once per module and shared by the port engines'
    cases."""
    cache = {}

    def get(async_engine, hot):
        key = (async_engine, hot)
        if key not in cache:
            ref = RefCluster(engine="numpy", async_engine=async_engine,
                             hot_key_threshold=hot, **KW)
            trans = scenario(ref, RefYCSBConfig(num_objects=N_OBJ),
                             ref_run_workload)
            cache[key] = snapshot(ref, trans)
        return cache[key]
    return get


@pytest.mark.parametrize("engine", ["torch:cpu", "cuda-on-cpu"])
@pytest.mark.parametrize("async_engine,hot", [
    (False, 0.0), (True, 0.0), (False, 3.0), (True, 3.0)])
def test_twin_cluster_matches_reference(reference_runs, engine,
                                        async_engine, hot):
    ref = reference_runs(async_engine, hot)
    cl = MemECCluster(engine=port_engine(engine), async_engine=async_engine,
                      hot_key_threshold=hot, **KW)
    got = snapshot(cl, scenario(cl, YCSBConfig(num_objects=N_OBJ),
                                run_workload))
    assert any(t.get("recovered_chunks", 0) > 0
               for _, t in got["transitions"]), \
        "no sealed chunk was recovered: the scenario missed the decode path"
    assert all(v is not None for v in got["contents"])
    for key in ("transitions", "stats", "contents", "regions"):
        assert got[key] == ref[key], f"{key} differ from the reference"
    checked, bad = parity_invariant(cl)
    assert checked > 0 and bad == 0
    if hot:
        assert got["stats"]["hot_tier"]["buffered_updates"] > 0
    # every coding op of the path went through the engine's device hooks
    paths = cl.engine.op_paths
    want = "torch-plain" if engine == "torch:cpu" else "torch-cpu"
    assert set(paths.values()) == {want}, paths
    assert {"matmul", "delta_per_item"} <= set(paths), paths
    if engine == "cuda-on-cpu":
        assert "delta" in paths, paths


RDP_KW = dict(KW, scheme="rdp")         # RDP(10,8), p = 17: Cb = 32


@pytest.fixture(scope="module")
def rdp_reference_runs():
    """The reference RDP cluster's end-state snapshot per hot setting."""
    cache = {}

    def get(hot):
        if hot not in cache:
            ref = RefCluster(engine="numpy", hot_key_threshold=hot, **RDP_KW)
            trans = scenario(ref, RefYCSBConfig(num_objects=N_OBJ),
                             ref_run_workload)
            cache[hot] = snapshot(ref, trans)
        return cache[hot]
    return get


@pytest.mark.parametrize("engine", ["torch:cpu", "cuda-on-cpu"])
@pytest.mark.parametrize("hot", [0.0, 3.0])
def test_rdp_twin_cluster_matches_reference(rdp_reference_runs, engine, hot):
    ref = rdp_reference_runs(hot)
    eng = (CudaEngine(make_code("rdp", 10, 8), device="cpu")
           if engine == "cuda-on-cpu" else engine)
    cl = MemECCluster(engine=eng, hot_key_threshold=hot, **RDP_KW)
    assert cl.engine.rep.r == 16 and cl.chunk_size // cl.engine.rep.r == 32
    got = snapshot(cl, scenario(cl, YCSBConfig(num_objects=N_OBJ),
                                run_workload))
    assert any(t.get("recovered_chunks", 0) > 0
               for _, t in got["transitions"])
    assert all(v is not None for v in got["contents"])
    for key in ("transitions", "stats", "contents", "regions"):
        assert got[key] == ref[key], f"{key} differ from the reference"
    checked, bad = parity_invariant(cl)
    assert checked > 0 and bad == 0
    if hot:
        assert got["stats"]["hot_tier"]["buffered_updates"] > 0
    # r > 1: every delta took the per-item path, never the r = 1 kernel
    paths = cl.engine.op_paths
    want = "torch-plain" if engine == "torch:cpu" else "torch-cpu"
    assert set(paths.values()) == {want}, paths
    assert {"matmul", "delta_per_item"} <= set(paths), paths
    assert "delta" not in paths, paths


def test_configured_cluster_takes_the_port_engine_names():
    from repro_torch.configs import memec_config
    from repro_torch.configs.memec import make_configured_cluster
    cfg = memec_config()
    cl = make_configured_cluster(cfg, engine="torch:cpu")
    assert (cl.n, cl.k, cl.chunk_size, len(cl.servers), cl.num_proxies) == \
        (cfg.n, cfg.k, cfg.chunk_size, cfg.num_servers, cfg.num_proxies)
    assert cl.engine.name == "torch" and cl.engine.device.type == "cpu"
    assert make_configured_cluster(cfg, engine="numpy").engine.name == "numpy"
