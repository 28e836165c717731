#!/usr/bin/env python3
"""Drive the PyTorch port of MemEC on one CUDA card and check every result.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing runs on the CPU
in place of the card):

1. device  - needs ``torch.cuda``; prints the card's name and power limit
             and the torch/CUDA versions;
2. build   - compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc;
3. kernels - each hand-written kernel against its plain torch version on
             the card, byte-exact, at B = 1, 64, 4096 and C = 4096, 1000;
             at B = 4096 and B = 64 (C = 4096): CUDA-event time of a
             wrapper call, the kernel's own device time from a
             ``torch.profiler`` trace, the plain version's time and the
             device-memory bound;
4. cluster - the paper's testbed (``configs/memec.py``: 16 servers,
             4 proxies, RS(10,8), c = 16, 4 KB chunks) on
             ``engine="cuda"``, YCSB batch 64: load, workload A, a
             data-server fail/restore, a parity-server fail/restore with
             A and D, against a twin on the numpy engine.  Contents,
             ``stats`` and the transitions must be equal, the parity sweep
             must find no stale parity, and every kernel must have
             launched.  The decodes of each ``fail_server`` are then
             replayed on the numpy, plain-torch and CUDA engines and
             timed.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/gf256.cu"

# H100 SXM data sheet: 3.35 TB/s of HBM; 1,979 TOP/s int8 is the card's
# highest rate for byte operations, so ops / that rate is a floor for any
# byte-wise formulation of a GF(2^8) multiply-XOR
HBM_BYTES_PER_S = 3.35e12
BYTE_OPS_PER_S = 1.979e15

OBJECTS = 200_000        # the smallest load at which the testbed seals
BATCH = 64               # YCSB multi-key window
A_OPS, DEGRADED_OPS, PARITY_DOWN_OPS = 20_000, 5_000, 2_000


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int) -> float:
    """CUDA-event time of a run of ``reps`` calls of ``fn`` after a
    warm-up, over ``reps``: what one call costs its caller, the wrapper's
    host work (coefficient copy, allocation, launch) included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(torch, fn, reps: int, cuda_name: str):
    """The kernel's own device time per launch: the durations of the CUDA
    kernels whose name holds ``cuda_name`` in a ``torch.profiler`` (CUPTI)
    trace of ``reps`` calls of ``fn``, over their count.  None when the
    trace holds no such kernel (the profiler saw no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and cuda_name in ev.name]
    return sum(spans) / len(spans) / 1e3 if spans else None


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BYTE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_specs(np, torch, dev):
    """Per kernel: how to make its inputs at (B, C), call the wrapper and
    the plain version, and count the bytes and operations it must do."""
    from repro_torch.core.codes import make_code
    from repro_torch.core.engine import block_rep
    from repro_torch.kernels import delta_update as du
    from repro_torch.kernels import gf256_matmul as gm

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    E = block_rep(make_code("rs", 10, 8)).encode          # (2, 8) encode
    # fused decode of two lost data chunks, re-encoding both parities:
    # [inv ; G_par ∘ inv] is (10, 8), the largest RS(10,8) decode matrix
    G = np.concatenate([np.eye(8, dtype=np.uint8), E])
    from repro_torch.core import gf256
    inv = gf256.gf_mat_inv(G[[2, 3, 4, 5, 6, 7, 8, 9]])
    fused = np.concatenate([inv, gf256.gf_matmul_np(E, inv)])

    def matmul(A):
        m, k = A.shape

        def make(B, C):
            return (A, u8((B, k, C)))
        return dict(make=make, kernel=gm.gf256_matmul_batched,
                    plain=gm.gf256_matmul_batched_plain,
                    nbytes=lambda B, C: B * k * C + B * m * C + m * k,
                    ops=lambda B, C: B * m * k * C)

    def fold_make(B, C):
        Ms = rng.integers(1, 256, (B, 1, 1), dtype=np.uint8)
        return (Ms, u8((B, 1, C)), u8((B, 1, C)))

    def delta_make(parity):
        def make(B, C):
            g = rng.integers(0, 256, (B, 2)).astype(np.int32)
            return ((u8((B, 2, C)) if parity else None), g, u8((B, C)))
        return make

    # ``cuda_name``: the __global__ function in csrc/gf256.cu, as the
    # profiler names the launch
    return [
        dict(name="gf_matmul_batched", cuda_name="matmul_batched_kernel",
             replaces="src/repro/kernels/gf256_matmul.py:95",
             cases={"decode_10x8": matmul(fused), "encode_2x8": matmul(E)}),
        dict(name="gf_per_item_fold", cuda_name="per_item_fold_kernel",
             replaces="src/repro/kernels/gf256_matmul.py:302",
             cases={"fold_Bx1x1": dict(
                 make=fold_make, kernel=gm.gf256_matmul_per_item_batched,
                 plain=gm.gf256_matmul_per_item_plain,
                 nbytes=lambda B, C: B + 3 * B * C,
                 ops=lambda B, C: B * C)}),
        dict(name="gf_delta_apply_batched", cuda_name="delta_batched_kernel",
             replaces="src/repro/kernels/delta_update.py:74",
             cases={"apply_m2": dict(
                 make=delta_make(True), kernel=du.delta_apply_batched,
                 plain=du.delta_apply_batched_plain,
                 nbytes=lambda B, C: 8 * B + 2 * B * 2 * C + B * C,
                 ops=lambda B, C: B * 2 * C)}),
        dict(name="gf_delta_only_batched", cuda_name="delta_batched_kernel",
             replaces="src/repro/kernels/delta_update.py:80",
             cases={"delta_m2": dict(
                 make=delta_make(False), kernel=du.delta_apply_batched,
                 plain=du.delta_apply_batched_plain,
                 nbytes=lambda B, C: 8 * B + B * 2 * C + B * C,
                 ops=lambda B, C: B * 2 * C)}),
    ]


def run_kernels(np, torch, dev):
    """Hold every kernel against its plain version; time both."""
    rows = []
    for spec in kernel_specs(np, torch, dev):
        row = dict(name=spec["name"], route="cuda", source=SOURCE,
                   replaces=spec["replaces"], checked=[])
        for case_name, case in spec["cases"].items():
            for C in (4096, 1000):
                for B in (1, 64, 4096):
                    args = case["make"](B, C)
                    got = case["kernel"](*args)
                    want = case["plain"](*args)
                    torch.cuda.synchronize()
                    diff = (got != want)
                    if bool(diff.any()):
                        first = int(diff.reshape(-1).nonzero()[0])
                        raise AssertionError(
                            f"{spec['name']} {case_name} B={B} C={C}: "
                            f"first differing byte at flat index {first}")
                    row["checked"].append(f"{case_name} B={B} C={C}")
            timing = {}
            for B, reps in ((4096, 20), (64, 200)):
                C = 4096
                args = case["make"](B, C)
                call = lambda: case["kernel"](*args)          # noqa: E731
                ms = cuda_ms(torch, call, reps)
                kernel_ms = kernel_device_ms(torch, call, reps,
                                             spec["cuda_name"])
                plain_ms = cuda_ms(torch, lambda: case["plain"](*args),
                                   max(3, reps // 10))
                b_ms, by = bound(case["nbytes"](B, C), case["ops"](B, C))
                timing[B] = dict(ms=ms, kernel_ms=kernel_ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=by, bytes=case["nbytes"](B, C),
                                 ops=case["ops"](B, C))
                kernel_txt = ("not measured (no device time in the trace)"
                              if kernel_ms is None else f"{kernel_ms:.4f} ms")
                log(f"kernel {spec['name']} {case_name} B={B} C={C}: "
                    f"wrapper {ms:.4f} ms, kernel {kernel_txt} (plain "
                    f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by})")
            row.setdefault("cases", {})[case_name] = {
                f"{k}_b{B}": v for B, t in timing.items()
                for k, v in t.items()}
            if "ms" not in row:       # the first case is the headline
                t = timing[4096]
                row.update(ms=t["ms"], kernel_ms=t["kernel_ms"],
                           plain_ms=t["plain_ms"],
                           bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                           library_ms=None, shape=f"{case_name} B=4096 C=4096")
        rows.append(row)
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------

def parity_invariant(np, cl):
    """Every sealed data chunk must decode (numpy RS) from the rest of its
    stripe; returns (checked, bad)."""
    from repro_torch.core.chunk import ChunkId
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
                c = cl.servers[sl.servers[i]].get_sealed_chunk(
                    ChunkId(cid.stripe_list_id, cid.stripe_id, i))
                avail[i] = c if c is not None else np.zeros(cs, np.uint8)
            rec = cl.code.decode(avail, [cid.position], cs)[cid.position]
            checked += 1
            bad += 0 if np.array_equal(rec, s.region[idx]) else 1
    return checked, bad


def victim(cl, parity_side: bool) -> int:
    """The server holding the most sealed data (or parity) chunks."""
    def count(srv):
        return sum(1 for idx, cid in enumerate(srv.chunk_ids)
                   if cid is not None and srv.sealed[idx]
                   and (cid.position >= cl.k) == parity_side)
    return max(range(len(cl.servers)), key=lambda s: count(cl.servers[s]))


def sealed_chunks(cl) -> int:
    return sum(int(sum(bool(x) for x in s.sealed)) for s in cl.servers)


def scenario(cl, cfg, run_workload) -> tuple[list, dict, dict, dict]:
    """load -> A -> fail data server -> A -> restore -> fail parity server
    -> A, D -> restore.  Returns (transitions, seconds per phase, counts,
    and per ``fail_*`` phase the inputs of its engine decodes)."""
    secs, trans, decodes = {}, [], {}

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    def fail(name, sid):
        calls = []
        submit = cl.engine.submit_decode

        def recording(available, wanted, chunk_size):
            calls.append((available, wanted, chunk_size))
            return submit(available, wanted, chunk_size)
        cl.engine.submit_decode = recording
        try:
            trans.append((name, sid, phase(name, lambda: cl.fail_server(sid))))
        finally:
            del cl.engine.submit_decode
        # copied before any later request can change a chunk in place
        decodes[name] = copy.deepcopy(calls)

    phase("load", lambda: run_workload(cl, "load", 0, cfg, batch_size=BATCH))
    phase("A", lambda: run_workload(cl, "A", A_OPS, cfg, batch_size=BATCH))
    counts = {"sealed_after_load_A": sealed_chunks(cl)}
    sid = victim(cl, False)
    fail("fail_data", sid)
    phase("A_degraded", lambda: run_workload(cl, "A", DEGRADED_OPS, cfg,
                                             batch_size=BATCH))
    trans.append(("restore_data", sid, phase(
        "restore_data", lambda: cl.restore_server(sid))))
    sid = victim(cl, True)
    fail("fail_parity", sid)
    phase("A_parity_down", lambda: run_workload(
        cl, "A", PARITY_DOWN_OPS, cfg, batch_size=BATCH))
    phase("D_parity_down", lambda: run_workload(
        cl, "D", PARITY_DOWN_OPS, cfg, batch_size=BATCH))
    trans.append(("restore_parity", sid, phase(
        "restore_parity", lambda: cl.restore_server(sid))))
    counts["sealed_end"] = sealed_chunks(cl)
    counts["recovered_chunks"] = {
        t[0]: t[2].get("recovered_chunks", 0) for t in trans
        if t[0].startswith("fail")}
    return trans, secs, counts, decodes


def replay_decodes(np, torch, code, decodes) -> dict:
    """Where a ``fail_server`` spends its coding time: replay the decodes
    each fail phase made on fresh engines (cold plan caches, as the
    cluster's engine met them) - the numpy engine, the plain torch
    versions on the card, and the CUDA kernels - in the order numpy,
    torch, cuda, cuda, torch, numpy.  Host seconds per replay, each ending
    in the copy back to the host; the outputs must agree."""
    from repro_torch.core.engine import CudaEngine, NumpyEngine, TorchEngine
    order = (("numpy", NumpyEngine), ("torch", TorchEngine),
             ("cuda", CudaEngine))
    out = {}
    for phase_name, calls in decodes.items():
        row = {"calls": len(calls),
               "items": sum(len(a) for a, _, _ in calls)}
        results = {}
        for name, cls in order + order[::-1]:
            eng = cls(code)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [eng.submit_decode(a, w, cs).result() for a, w, cs in calls]
            row.setdefault(f"{name}_s", []).append(time.perf_counter() - t0)
            results.setdefault(name, got)
        want = results["numpy"]
        for name, got in results.items():
            for g_call, w_call in zip(got, want):
                for g, w in zip(g_call, w_call):
                    assert g.keys() == w.keys() and all(
                        np.array_equal(g[p], w[p]) for p in w), \
                        f"{phase_name}: {name} decode differs from numpy"
        out[phase_name] = row
    return out


def contents(cl, cfg):
    from repro_torch.data.ycsb import YCSBWorkload
    w = YCSBWorkload(cfg)
    keys = [w.key(i) for i in range(cfg.num_objects + PARITY_DOWN_OPS)]
    out = []
    for s in range(0, len(keys), 4096):
        out.extend(cl.multi_get(keys[s:s + 4096]))
    return out


def run_cluster(np, torch):
    from repro_torch.configs.memec import CONFIG, make_configured_cluster
    from repro_torch.data.ycsb import YCSBConfig, run_workload
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = YCSBConfig(num_objects=OBJECTS, key_size=CONFIG.key_size,
                     value_sizes=CONFIG.value_sizes)
    cl = make_configured_cluster(CONFIG, engine="cuda")
    twin = make_configured_cluster(CONFIG, engine="numpy")
    log(f"cluster: {CONFIG.num_servers} servers, {CONFIG.num_proxies} "
        f"proxies, {CONFIG.scheme.upper()}({CONFIG.n},{CONFIG.k}), "
        f"c={CONFIG.c}, chunk {CONFIG.chunk_size} B, {OBJECTS} objects, "
        f"YCSB batch {BATCH}")
    reset_launch_counts()
    trans, secs, counts, decodes = scenario(cl, cfg, run_workload)
    torch.cuda.synchronize()
    launches = launch_counts()
    log("cluster cuda seconds per phase:", json.dumps(secs))
    log("cluster cuda launches per kernel:", json.dumps(launches))
    log("cluster cuda engine:", json.dumps(cl.engine.stats()))
    log("cluster chunks:", json.dumps(counts))
    twin_trans, twin_secs, twin_counts, _ = scenario(twin, cfg, run_workload)
    log("cluster numpy twin seconds per phase:", json.dumps(twin_secs))
    log("fail_server decodes replayed (host s per engine):",
        json.dumps(replay_decodes(np, torch, cl.code, decodes)))

    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    paths = set(cl.engine.op_paths.values())
    assert paths == {"cuda-kernel"}, f"op_paths {cl.engine.op_paths}"
    assert counts["sealed_after_load_A"] > 0, "no chunk sealed"
    assert counts["recovered_chunks"]["fail_data"] > 0, "nothing recovered"
    assert trans == twin_trans, "fail/restore transitions differ"
    assert counts == twin_counts, (counts, twin_counts)
    assert cl.stats == twin.stats, "cluster stats differ from the twin"
    got, want = contents(cl, cfg), contents(twin, cfg)
    assert got == want, "contents differ from the numpy twin"
    assert all(v is not None for v in got[:OBJECTS]), "a loaded key is lost"
    checked, bad = parity_invariant(np, cl)
    log(f"parity sweep: {checked} sealed data chunks checked, {bad} bad")
    assert checked > 0 and bad == 0
    return launches, secs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    _build.library()                    # nvcc at first use, then ctypes
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)} of {', '.join(_build.SOURCES)})")

    rows = run_kernels(np, torch, dev)
    launches, secs = run_cluster(np, torch)
    for row in rows:
        row["launches"] = launches[row["name"]]
        log(json.dumps({k: row[k] for k in (
            "name", "launches", "ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape")}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
