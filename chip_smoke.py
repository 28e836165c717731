#!/usr/bin/env python3
"""Drive the PyTorch port of MemEC on one CUDA card and check every result.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing runs on the CPU
in place of the card):

1. device  - needs ``torch.cuda``; prints the card's name and power limit
             and the torch/CUDA versions;
2. build   - compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc;
3. kernels - each of the ten hand-written kernels against its plain
             torch version on the card, byte-exact: the batched ones at
             B = 1, 64, 4096 and C = 4096, 1000 (and C = 256, RDP's
             sub-block row, for the RDP shapes), the single-stripe ones at
             C = 4096, 1000 and 1 MiB, the probe at Q = 1, 64, 65,536 on a
             2^20-bucket table; at the widths the main path gives each
             kernel: CUDA-event time of a wrapper call, the kernel's own
             device time from a ``torch.profiler`` trace, the plain
             version's time and the bound from these inputs' bytes and
             operations;
4. RS      - the paper's testbed (``configs/memec.py``: 16 servers,
             4 proxies, RS(10,8), c = 16, 4 KB chunks) on
             ``engine="cuda"``, YCSB batch 64: load, workload A, a
             data-server fail/restore, a parity-server fail/restore with
             A and D, against a twin on the numpy engine.  Contents,
             ``stats`` and the transitions must be equal, the parity sweep
             must find no stale parity, and the RS kernels must have
             launched.  The decodes of each ``fail_server`` are then
             replayed on the numpy, plain-torch and CUDA engines and
             timed;
5. RDP     - the same scenario with ``scheme="rdp"`` (RDP(10,8), p = 17,
             sixteen 256-byte sub-blocks per chunk): the 0/1 kernel, the
             per-item kernel and the per-item fold must have launched;
6. RS(14,10) - one ``CudaEngine`` decode of 200 stripes whose patterns
             re-encode three or four parities, against ``NumpyEngine``:
             the column-loop kernel must have launched;
7. ops     - ``repro_torch.kernels.ops`` on RS(10,8) 4 KB chunks (encode,
             decode of two lost positions, a parity delta, an index
             probe) against ``core.codes`` and the index, then
             ``repro_torch.quickstart`` on the card: kernels 8-10 (the
             single-stripe product, the fused old/new delta, the cuckoo
             probe) must have launched;
8. sharded - ``configs/memec.py`` with ``shards=4, placement="ring"``:
             four paper testbeds as the shards of one cluster, sharing
             the card, on ``engine="cuda"`` against a numpy twin - load,
             A, a data-server fail/restore in one shard with A running,
             ``add_shard`` (live migration) and ``rebalance``.  Contents,
             ``stats`` and reports must be equal, every shard's parity
             sweep must find no stale parity, and the seal, delta and
             decode kernels must have launched.

Kernel 10 is also held against its plain version on the real object
index of a server of the loaded RS testbed.  Every phase of 4-8 starts
with the launch counts at 0 and reads them when it ends; launches made
to compare a kernel with its plain version are not counted.  The line
before the last is ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import copy
import importlib
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
# workload ops: A, A with a data server down, A and D with a parity
# server down
OPS = dict(A=20_000, degraded=5_000, parity_down=2_000)
# the sharded phase: four testbed shards on a ring; at this load the
# smallest shard (22.5 % of the keys) holds about 54,000 objects and
# seals chunks (each shard starts sealing near 40,000)
SHARDED_OBJECTS = 240_000
SHARDED_OPS = dict(A=20_000, degraded=5_000, hot=4_000)
# keys ``rebalance`` moves in one pass; the rest stay forwarded and
# readable (an uncapped pass moves ~100,000 keys at this load)
REBALANCE_MOVES = 20_000


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


def matmul_work(np, A, data, gf01=False):
    """Bytes a shared-matrix product must move (each input once, each
    output once, the matrix as the kernel reads it) and its
    multiply-XORs: one per nonzero coefficient and output byte."""
    B, k, C = data.shape
    m = A.shape[0]
    mat = m * -(-k // 32) * 4 if gf01 else m * k
    return B * k * C + B * m * C + mat, int(np.count_nonzero(A)) * B * C


def per_item_work(np, Ms, blocks, parity=None):
    B, O, J = Ms.shape
    C = blocks.shape[2]
    out = (2 if parity is not None else 1) * B * O * C
    return Ms.size + B * J * C + out, int(np.count_nonzero(Ms)) * C


def delta_work(np, parity, g, xor):
    B, m = g.shape
    C = xor.shape[1]
    out = (2 if parity is not None else 1) * B * m * C
    return 4 * B * m + B * C + out, int(np.count_nonzero(g & 255)) * C


def single_matmul_work(np, A, data):
    """The single-stripe product's bytes (data in, result out, the
    matrix) and multiply-XORs (one per nonzero coefficient and byte)."""
    k, C = data.shape
    m = A.shape[0]
    return k * C + m * C + m * k, int(np.count_nonzero(A)) * C


def single_delta_work(np, parity, g, old, new):
    """Parity, old and new read once, parity written once, the gammas;
    one multiply-XOR per nonzero gamma and byte."""
    m, C = parity.shape
    g = np.asarray(g)
    return 2 * m * C + 2 * C + 4 * m, int(np.count_nonzero(g & 255)) * C


def probe_work(np, num_buckets, h1, h2):
    """Bytes the probe's queries touch, not the table: per query its
    fingerprint (8 B), two bucket ids (8 B) and two outputs (5 B), and per
    distinct bucket it names one row of 4 fingerprints and 4 occupancy
    bytes (36 B); one 64-bit compare per slot read."""
    rows = 1 + ((h1 % np.uint64(num_buckets)) != (h2 % np.uint64(num_buckets)))
    n_rows = int(rows.sum())
    return 21 * len(h1) + 36 * n_rows, 4 * n_rows


def probe_table(np, buckets: int, occupancy: float, queries: int, seed: int):
    """A cuckoo table of ``buckets`` x 4 random fingerprints, about
    ``occupancy`` of the slots occupied, and ``queries`` probes: half hit
    an occupied slot through the bucket their h1 or h2 names, half miss,
    and one in 16 has h1 == h2 (both probes on one bucket).  numpy from a
    fixed seed."""
    rng = np.random.default_rng(seed)

    def u64(n):
        return np.frombuffer(rng.bytes(8 * n), dtype=np.uint64).copy()
    fps = u64(buckets * 4).reshape(buckets, 4)
    occ = rng.random((buckets, 4)) < occupancy
    B = np.uint64(buckets)
    hits = queries // 2
    pick = rng.choice(np.flatnonzero(occ), hits)
    named = (pick // 4).astype(np.uint64) + B * (u64(hits) >> np.uint64(21))
    other = u64(hits)
    side = rng.random(hits) < 0.5
    h1 = np.concatenate([np.where(side, named, other), u64(queries - hits)])
    h2 = np.concatenate([np.where(side, other, named), u64(queries - hits)])
    fp = np.concatenate([fps.reshape(-1)[pick], u64(queries - hits)])
    same = rng.random(queries) < 1 / 16
    h2[same] = h1[same]
    order = rng.permutation(queries)
    return fps, occ, h1[order], h2[order], fp[order]


def kernel_specs(np, torch, dev):
    """Per kernel: how to make its inputs at (B, C), call the wrapper and
    the plain version, the (B, C) grid it is checked on, the width it is
    timed at (the main path's), and the bytes and operations that these
    inputs need."""
    from repro_torch.core.codes import make_code
    from repro_torch.core.engine import NumpyEngine, block_rep
    du = importlib.import_module("repro_torch.kernels.delta_update")
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    cl = importlib.import_module("repro_torch.kernels.cuckoo_lookup")

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def fused(scheme, n, k, avail, wanted):
        """The fused decode matrix [inv ; G_par o inv] the engine builds
        for one erasure pattern."""
        eng = NumpyEngine(make_code(scheme, n, k))
        return eng._fused_decode_matrix(
            eng.plan_decode([avail], [wanted], 4096).groups[0])

    E = block_rep(make_code("rs", 10, 8)).encode          # (2, 8) encode
    # fused decode of two lost data chunks, re-encoding both parities:
    # [inv ; G_par o inv] is (10, 8), the largest RS(10,8) decode matrix
    rs_dec = fused("rs", 10, 8, range(2, 10), (0, 1, 8, 9))
    # RS(14,10): a lost data chunk, all four parities re-encoded
    f4_dec = fused("rs", 14, 10, range(1, 14), (0, 10, 11, 12, 13))
    # RDP(10,8), r = 16: the (32, 128) block encode matrix and the fused
    # decode of two lost data chunks with both parities, (160, 128)
    rdp = make_code("rdp", 10, 8)
    R = block_rep(rdp).encode
    r = R.shape[0] // 2
    rdp_dec = fused("rdp", 10, 8, range(2, 10), (0, 1, 8, 9))
    assert gm.choose_strategy(rs_dec) == "unroll"
    assert gm.choose_strategy(f4_dec) == "cols" and f4_dec.shape == (14, 10)
    assert gm.choose_strategy(R) == "gf01" and R.shape == (32, 128)
    assert gm.choose_strategy(rdp_dec) == "gf01"
    assert rdp_dec.shape == (160, 128)

    RS_C, RDP_C = (4096, 1000), (4096, 1000, 256)

    def batched(check_C, time_C):
        """The (B, C) grid a batched kernel is checked on, and its timed
        points at the main path's width."""
        return dict(check=[(B, C) for C in check_C for B in (1, 64, 4096)],
                    timed=[("b4096", (4096, time_C), 20),
                           ("b64", (64, time_C), 200)])

    def matmul(A, strategy, check_C, time_C):
        m, k = A.shape
        plain = (gm.gf01_matmul_batched_plain if strategy == "gf01"
                 else gm.gf256_matmul_batched_plain)
        return dict(make=lambda B, C: (A, u8((B, k, C))),
                    kernel=gm.gf256_matmul_batched, plain=plain,
                    work=lambda a: matmul_work(np, *a,
                                               gf01=strategy == "gf01"),
                    **batched(check_C, time_C))

    def rdp_delta_make(B, C):
        """What ``submit_delta`` hands the kernel for RDP: per item the
        (m*r, r) columns of the data chunk it mutates."""
        idx = rng.integers(0, rdp.k, B)
        cols = R.reshape(2 * r, rdp.k, r)[:, idx, :]
        return (np.ascontiguousarray(np.transpose(cols, (1, 0, 2))),
                u8((B, r, C)))

    def fold_make(O):
        def make(B, C):
            if O == 1:
                Ms = rng.integers(1, 256, (B, 1, 1), dtype=np.uint8)
            else:
                # RDP seal: the (r, r) system of one parity row and chunk
                E4 = R.reshape(2, r, rdp.k, r)
                Ms = np.ascontiguousarray(E4[rng.integers(0, 2, B), :,
                                             rng.integers(0, rdp.k, B), :])
            return (Ms, u8((B, O, C)), u8((B, O, C)))
        return make

    def delta_make(parity):
        def make(B, C):
            g = rng.integers(0, 256, (B, 2)).astype(np.int32)
            return ((u8((B, 2, C)) if parity else None), g, u8((B, C)))
        return make

    def per_item_case(make, check_C, time_C):
        return dict(make=make, kernel=gm.gf256_matmul_per_item_batched,
                    plain=gm.gf256_matmul_per_item_plain,
                    work=lambda a: per_item_work(np, *a),
                    **batched(check_C, time_C))

    def delta_case(parity):
        return dict(make=delta_make(parity), kernel=du.delta_apply_batched,
                    plain=du.delta_apply_batched_plain,
                    work=lambda a: delta_work(np, *a),
                    **batched(RS_C, 4096))

    # kernels 8-10, the single-stripe entries of kernels/ops.py and the
    # index probe: RS(10,8) encode (2,8) and the decode inverse of two lost
    # data chunks (8,8), at one 4 KB chunk and at 1 MiB
    rs = make_code("rs", 10, 8)
    inv, _ = rs.decode_matrix(list(range(2, 10)))
    assert inv.shape == (8, 8) and gm.choose_strategy(inv) == "unroll"
    WIDE = 1 << 20

    def single(A):
        k = A.shape[1]
        return dict(make=lambda C: (A, u8((k, C))), kernel=gm.gf256_matmul,
                    plain=gm.gf256_matmul_plain,
                    work=lambda a: single_matmul_work(np, *a),
                    check=[(4096,), (1000,), (WIDE,)],
                    timed=[("c4096", (4096,), 200), ("c1048576", (WIDE,), 20)])

    def single_delta_make(C):
        g = rng.integers(1, 256, 2).astype(np.int32)
        return (u8((2, C)), g, u8((C,)), u8((C,)))

    # the probe: 2^20 buckets (4 M slots, 90 % occupied, 36 MB of table
    # on the card), Q = 64 (a YCSB window) and Q = 65,536
    fps, occ, h1, h2, fp = probe_table(np, 1 << 20, 0.9, 1 << 16, seed=20)
    fps_d = torch.from_numpy(fps.view(np.int64)).to(dev)
    occ_d = torch.from_numpy(occ).to(dev)

    def probe_plain(fps_t, occ_t, a, b, f):
        return cl.cuckoo_probe_plain(
            fps_t, occ_t, *cl.query_tensors(a, b, f, fps_t.shape[0],
                                            fps_t.device))

    # ``cuda_name``: the __global__ function in csrc/gf256.cu, as the
    # profiler names the launch
    return [
        dict(name="gf_matmul_batched", cuda_name="matmul_batched_kernel",
             replaces="src/repro/kernels/gf256_matmul.py:95",
             cases={"decode_10x8": matmul(rs_dec, "unroll", RS_C, 4096),
                    "encode_2x8": matmul(E, "unroll", RS_C, 4096)}),
        dict(name="gf_matmul_cols_batched",
             cuda_name="matmul_cols_kernel",
             replaces="src/repro/kernels/gf256_matmul.py:124",
             cases={"decode_14x10": matmul(f4_dec, "cols", RS_C, 4096)}),
        dict(name="gf01_matmul_batched", cuda_name="gf01_matmul_kernel",
             replaces="src/repro/kernels/gf256_matmul.py:154",
             cases={"encode_32x128": matmul(R, "gf01", RDP_C, 256),
                    "decode_160x128": matmul(rdp_dec, "gf01", RDP_C, 256)}),
        dict(name="gf_per_item",
             cuda_name="per_item_kernel",
             replaces="src/repro/kernels/gf256_matmul.py:297",
             cases={"delta_Bx32x16": per_item_case(rdp_delta_make, RDP_C,
                                                   256)}),
        dict(name="gf_per_item_fold",
             cuda_name="per_item_kernel",
             replaces="src/repro/kernels/gf256_matmul.py:302",
             cases={"fold_Bx1x1": per_item_case(fold_make(1), RS_C, 4096),
                    "fold_Bx16x16": per_item_case(fold_make(r), RDP_C,
                                                  256)}),
        dict(name="gf_delta_apply_batched",
             cuda_name="delta_batched_kernel",
             replaces="src/repro/kernels/delta_update.py:74",
             cases={"apply_m2": delta_case(True)}),
        dict(name="gf_delta_only_batched",
             cuda_name="delta_batched_kernel",
             replaces="src/repro/kernels/delta_update.py:80",
             cases={"delta_m2": delta_case(False)}),
        dict(name="gf_matmul", cuda_name="matmul_batched_kernel",
             replaces="src/repro/kernels/gf256_matmul.py:66",
             cases={"encode_2x8": single(rs.parity_matrix),
                    "decode_8x8": single(inv)}),
        dict(name="gf_delta_update", cuda_name="delta_update_kernel",
             replaces="src/repro/kernels/delta_update.py:28",
             cases={"update_m2": dict(
                 make=single_delta_make, kernel=du.delta_update,
                 plain=du.delta_update_plain,
                 work=lambda a: single_delta_work(np, *a),
                 check=[(4096,), (1000,), (WIDE,)],
                 timed=[("c4096", (4096,), 200),
                        ("c1048576", (WIDE,), 20)])}),
        dict(name="gf_cuckoo_probe", cuda_name="cuckoo_probe_kernel",
             replaces="src/repro/kernels/cuckoo_lookup.py:29",
             cases={"probe_2e20": dict(
                 make=lambda Q: (fps_d, occ_d, h1[:Q], h2[:Q], fp[:Q]),
                 kernel=cl.cuckoo_lookup, plain=probe_plain,
                 work=lambda a: probe_work(np, a[0].shape[0], a[2], a[3]),
                 check=[(1,), (64,), (1 << 16,)],
                 timed=[("q64", (64,), 200), ("q65536", (1 << 16,), 20)])}),
    ]


def max_err(torch, got, want) -> int:
    """Largest absolute difference over a kernel's output(s)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(int((g.int() - w.int()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def run_kernels(np, torch, dev):
    """Hold every kernel against its plain version; time both."""
    rows = []
    for spec in kernel_specs(np, torch, dev):
        row = dict(name=spec["name"], route="cuda", source=SOURCE,
                   replaces=spec["replaces"], checked=[], max_abs_err=0)
        for case_name, case in spec["cases"].items():
            for shape in case["check"]:
                args = case["make"](*shape)
                got = case["kernel"](*args)
                want = case["plain"](*args)
                torch.cuda.synchronize()
                err = max_err(torch, got, want)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                if err:
                    raise AssertionError(
                        f"{spec['name']} {case_name} {shape}: max abs err "
                        f"{err} against the plain version")
                row["checked"].append(f"{case_name} {shape}")
                del args, got, want
            timing = {}
            for label, shape, reps in case["timed"]:
                args = case["make"](*shape)
                call = lambda: case["kernel"](*args)          # noqa: E731
                ms = cuda_ms(torch, call, reps)
                kernel_ms = kernel_device_ms(torch, call, reps,
                                             spec["cuda_name"])
                plain_ms = cuda_ms(torch, lambda: case["plain"](*args),
                                   max(3, reps // 10))
                nbytes, ops = case["work"](args)
                b_ms, by = bound(nbytes, ops)
                timing[label] = dict(ms=ms, kernel_ms=kernel_ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=by, bytes=nbytes, ops=ops)
                kernel_txt = ("not measured (no device time in the trace)"
                              if kernel_ms is None else f"{kernel_ms:.4f} ms")
                log(f"kernel {spec['name']} {case_name} {label} {shape}: "
                    f"wrapper {ms:.4f} ms, kernel {kernel_txt} (plain "
                    f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by}, "
                    f"{nbytes} bytes)")
                del args
            row.setdefault("cases", {})[case_name] = {
                "shapes": {label: str(shape)
                           for label, shape, _ in case["timed"]},
                **{f"{k}_{label}": v for label, t in timing.items()
                   for k, v in t.items()}}
            if "ms" not in row:       # the first timed point is the headline
                label, shape, _ = case["timed"][0]
                t = timing[label]
                row.update(ms=t["ms"], kernel_ms=t["kernel_ms"],
                           plain_ms=t["plain_ms"],
                           bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                           library_ms=None,
                           shape=f"{case_name} {label} {shape}")
        rows.append(row)
        torch.cuda.empty_cache()
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
    phase("A", lambda: run_workload(cl, "A", OPS["A"], cfg,
                                    batch_size=BATCH))
    counts = {"sealed_after_load_A": sealed_chunks(cl)}
    sid = victim(cl, False)
    fail("fail_data", sid)
    phase("A_degraded", lambda: run_workload(cl, "A", OPS["degraded"], cfg,
                                             batch_size=BATCH))
    trans.append(("restore_data", sid, phase(
        "restore_data", lambda: cl.restore_server(sid))))
    sid = victim(cl, True)
    fail("fail_parity", sid)
    phase("A_parity_down", lambda: run_workload(
        cl, "A", OPS["parity_down"], cfg, batch_size=BATCH))
    phase("D_parity_down", lambda: run_workload(
        cl, "D", OPS["parity_down"], cfg, batch_size=BATCH))
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


def contents(cl, cfg, inserted):
    from repro_torch.data.ycsb import YCSBWorkload
    w = YCSBWorkload(cfg)
    keys = [w.key(i) for i in range(cfg.num_objects + inserted)]
    out = []
    for s in range(0, len(keys), 4096):
        out.extend(cl.multi_get(keys[s:s + 4096]))
    return out


# the kernels each main-path phase must launch
RS_KERNELS = ("gf_matmul_batched", "gf_per_item_fold", "gf_delta_apply_batched",
              "gf_delta_only_batched")
RDP_KERNELS = ("gf01_matmul_batched", "gf_per_item", "gf_per_item_fold")
COLS_KERNELS = ("gf_matmul_cols_batched",)
OPS_KERNELS = ("gf_matmul", "gf_delta_update", "gf_cuckoo_probe")
# seal folds, sealed-update deltas and recovery decodes
SHARDED_KERNELS = ("gf_per_item_fold", "gf_delta_apply_batched",
                   "gf_matmul_batched")


def launched_in(torch, fn):
    """Run ``fn`` with every launch count at 0; return its result and the
    counts it left (read after the card has finished)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def run_cluster(np, torch, testbed, must_launch):
    """The testbed scenario on the CUDA engine against a numpy-engine
    twin; ``must_launch`` names the kernels the scenario has to launch.
    Returns the launches per kernel and the CUDA cluster."""
    from repro_torch.configs.memec import make_configured_cluster
    from repro_torch.data.ycsb import YCSBConfig, run_workload

    cfg = YCSBConfig(num_objects=OBJECTS, key_size=testbed.key_size,
                     value_sizes=testbed.value_sizes)
    cl = make_configured_cluster(testbed, engine="cuda")
    twin = make_configured_cluster(testbed, engine="numpy")
    tag = f"{testbed.scheme.upper()}({testbed.n},{testbed.k})"
    log(f"cluster {tag}: {testbed.num_servers} servers, "
        f"{testbed.num_proxies} proxies, c={testbed.c}, chunk "
        f"{testbed.chunk_size} B (r = {cl.engine.rep.r}), {OBJECTS} objects, "
        f"YCSB batch {BATCH}")
    t0 = time.perf_counter()
    (trans, secs, counts, decodes), launches = launched_in(
        torch, lambda: scenario(cl, cfg, run_workload))
    wall = time.perf_counter() - t0
    log(f"cluster {tag} cuda seconds per phase:", json.dumps(secs))
    log(f"cluster {tag} cuda launches per kernel:", json.dumps(launches))
    log(f"cluster {tag} cuda engine:", json.dumps(cl.engine.stats()))
    log(f"cluster {tag} chunks:", json.dumps(counts))
    t0 = time.perf_counter()
    twin_trans, twin_secs, twin_counts, _ = scenario(twin, cfg, run_workload)
    twin_wall = time.perf_counter() - t0
    log(f"cluster {tag} numpy twin seconds per phase:", json.dumps(twin_secs))
    log(f"cluster {tag} scenario wall seconds: cuda {wall:.3f}, numpy twin "
        f"{twin_wall:.3f}")
    log(f"cluster {tag} fail_server decodes replayed (host s per engine):",
        json.dumps(replay_decodes(np, torch, cl.code, decodes)))

    missing = [k for k in must_launch if launches[k] == 0]
    assert not missing, f"{tag}: kernels never launched: {missing}"
    paths = set(cl.engine.op_paths.values())
    assert paths == {"cuda-kernel"}, f"op_paths {cl.engine.op_paths}"
    if cl.engine.rep.r != 1:
        assert "delta" not in cl.engine.op_paths, cl.engine.op_paths
    assert counts["sealed_after_load_A"] > 0, "no chunk sealed"
    assert counts["recovered_chunks"]["fail_data"] > 0, "nothing recovered"
    assert trans == twin_trans, "fail/restore transitions differ"
    assert counts == twin_counts, (counts, twin_counts)
    assert cl.stats == twin.stats, "cluster stats differ from the twin"
    got = contents(cl, cfg, OPS["parity_down"])
    want = contents(twin, cfg, OPS["parity_down"])
    assert got == want, "contents differ from the numpy twin"
    assert all(v is not None for v in got[:OBJECTS]), "a loaded key is lost"
    checked, bad = parity_invariant(np, cl)
    log(f"cluster {tag} parity sweep: {checked} sealed data chunks checked, "
        f"{bad} bad")
    assert checked > 0 and bad == 0
    return launches, cl


def check_probe_on_index(np, torch, cl, row):
    """Kernel 10 on a real object index: the server of the loaded testbed
    holding the most keys, probed for all its resident keys plus as many
    absent ones, against the plain version and the index itself; then the
    keys-in time of ``ops.batched_index_lookup`` (host hashing, the table
    copied to the card) beside the arrays-in time of the kernel row."""
    from repro_torch.kernels import ops
    srv = max(cl.servers, key=lambda s: s.object_index.size)
    index = srv.object_index
    resident = index.keys()
    absent = [b"absent-key-%013d" % i for i in range(len(resident))]
    keys = resident + absent
    found, slot = ops.batched_index_lookup(index, keys)
    pf, ps = ops.batched_index_lookup(index, keys, device="cpu")
    torch.cuda.synchronize()
    assert torch.equal(found.cpu(), pf) and torch.equal(slot.cpu(), ps), \
        "probe on the testbed index differs from the plain version"
    assert found.cpu().numpy().tolist() == \
        [True] * len(resident) + [False] * len(absent)
    for key, s in zip(resident, slot.cpu().numpy()):
        b, sl = divmod(int(s), 4)
        assert index.slot_data[(b, sl)][0] == key
    row["checked"].append(
        f"testbed server {srv.sid} object index: {index.num_buckets} "
        f"buckets, {len(resident)} resident + {len(absent)} absent keys")
    keys_in = {}
    for q, reps in ((64, 50), (len(keys), 3)):
        probe = keys[:q]
        t0 = time.perf_counter()
        for _ in range(reps):
            ops.batched_index_lookup(index, probe)
        torch.cuda.synchronize()
        keys_in[f"keys_in_ms_q{q}"] = (time.perf_counter() - t0) / reps * 1e3
    row["keys_in"] = dict(keys_in, buckets=index.num_buckets)
    log(f"kernel gf_cuckoo_probe on the testbed index of server {srv.sid} "
        f"({index.num_buckets} buckets, {len(keys)} keys): equal to the "
        f"plain version; keys-in host ms per ops.batched_index_lookup: "
        f"{json.dumps(keys_in)}")


def run_wide_decode(np, torch):
    """RS(14,10) (f4's warm BLOB code) through ``CudaEngine``: one decode
    of 200 stripes of 4 KB chunks (about a ``fail_server`` recovery batch
    of the testbed) whose patterns re-encode three or four parities, so
    the fused matrices are (13, 10) and (14, 10) and take the column-loop
    kernel.  Held against ``NumpyEngine``."""
    stripes, C = 200, 4096
    from repro_torch.core.codes import make_code
    from repro_torch.core.engine import CudaEngine, NumpyEngine
    code = make_code("rs", 14, 10)
    rng = np.random.default_rng(1410)
    data = rng.integers(0, 256, (stripes, 10, C), dtype=np.uint8)
    ref = NumpyEngine(code)
    par = ref.encode_batch(data)
    patterns = [((0,), (0, 10, 11, 12)), ((1, 2), (1, 2, 10, 11, 12, 13)),
                ((10, 11, 12), (10, 11, 12)), ((10, 11, 12, 13),
                                               (10, 11, 12, 13))]
    avail, wanted = [], []
    for b in range(stripes):
        lost, want = patterns[b % len(patterns)]
        stripe = np.concatenate([data[b], par[b]])
        avail.append({p: stripe[p] for p in range(14) if p not in lost})
        wanted.append(list(want))
    eng = CudaEngine(code)
    t0 = time.perf_counter()
    got, launches = launched_in(
        torch, lambda: eng.submit_decode(avail, wanted, C).result())
    cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ref.decode_batch(avail, wanted, C)
    numpy_s = time.perf_counter() - t0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(
            np.array_equal(g[p], w[p]) for p in w), "RS(14,10) decode differs"
    shapes = sorted({M.shape for M in eng._fused_cache.values()})
    log(f"RS(14,10) decode of {stripes} stripes x {C} B, fused matrices "
        f"{shapes}: cuda {cuda_s:.4f} s, numpy {numpy_s:.4f} s (host s); "
        f"launches {json.dumps(launches)}")
    missing = [k for k in COLS_KERNELS if launches[k] == 0]
    assert not missing, f"RS(14,10) decode never launched {missing}"
    assert set(eng.op_paths.values()) == {"cuda-kernel"}, eng.op_paths
    return launches


def run_ops(np, torch):
    """The public entry points of ``repro_torch.kernels.ops`` on RS(10,8)
    4 KB chunks - encode, decode of two lost positions, a parity delta,
    an index probe - held against ``core.codes`` and the index, then the
    port's quickstart on the card (its own asserts must hold).  Kernels
    8-10 must launch."""
    from repro_torch import quickstart
    from repro_torch.core.codes import RSCode
    from repro_torch.core.index import CuckooIndex
    from repro_torch.kernels import ops
    code = RSCode(n=10, k=8)
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (8, 4096), dtype=np.uint8)
    new3 = data[3].copy()
    new3[100:900] = rng.integers(0, 256, 800, dtype=np.uint8)
    index = CuckooIndex(num_buckets=1 << 12)
    keys = [b"user%020d" % i for i in range(8000)]
    for i, key in enumerate(keys):
        index.insert(key, i)
    probe = keys[::2] + [b"none%020d" % i for i in range(4000)]

    def drive():
        d = torch.from_numpy(data).cuda()
        par = ops.encode_stripe(code, d)
        stripe = torch.cat([d, par])
        lost = (2, 9)
        rec = ops.decode_stripe(code, {i: stripe[i] for i in range(10)
                                       if i not in lost}, list(lost), 4096)
        upd = ops.apply_parity_delta(code, par, 3, d[3],
                                     torch.from_numpy(new3).cuda())
        found, slot = ops.batched_index_lookup(index, probe)
        quickstart.main([])
        return [x.cpu().numpy() for x in (par, rec[2], rec[9], upd, found,
                                          slot)]
    t0 = time.perf_counter()
    (par, rec2, rec9, upd, found, slot), launches = launched_in(torch, drive)
    secs = time.perf_counter() - t0
    want_par = code.encode(data)
    assert np.array_equal(par, want_par), "ops.encode_stripe differs"
    assert np.array_equal(rec2, data[2]) and np.array_equal(rec9, want_par[1])
    d2 = data.copy()
    d2[3] = new3
    assert np.array_equal(upd, code.encode(d2)), "apply_parity_delta differs"
    assert found.tolist() == [key in index for key in probe]
    for key, f, s in zip(probe, found, slot):
        if f:
            assert index.slot_data[divmod(int(s), 4)][0] == key
    log(f"phase ops (entry points + quickstart on the card): {secs:.1f} s; "
        f"launches {json.dumps(launches)}")
    missing = [k for k in OPS_KERNELS if launches[k] == 0]
    assert not missing, f"ops phase never launched {missing}"
    return launches


def sharded_scenario(cl, cfg, run_workload, batch: int):
    """load -> A -> fail a data server in the shard with the most sealed
    chunks -> A -> restore -> add_shard (live migration) -> A hammering
    shard 0 -> rebalance (at most ``REBALANCE_MOVES`` keys).  Returns
    (reports, seconds per phase, counts)."""
    secs, reports = {}, []

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    phase("load", lambda: run_workload(cl, "load", 0, cfg, batch_size=batch))
    phase("A", lambda: run_workload(cl, "A", SHARDED_OPS["A"], cfg,
                                    batch_size=batch))
    sealed = [sealed_chunks(sh) for sh in cl.shards]
    counts = {"sealed_per_shard_after_load_A": sealed}
    si = max(range(len(sealed)), key=lambda i: sealed[i])
    sid = victim(cl.shards[si], False)
    reports.append(("fail", si, sid, phase(
        "fail", lambda: cl.fail_server(sid, shard=si))))
    phase("A_degraded", lambda: run_workload(
        cl, "A", SHARDED_OPS["degraded"], cfg, batch_size=batch))
    reports.append(("restore", si, sid, phase(
        "restore", lambda: cl.restore_server(sid, shard=si))))
    reports.append(("add_shard", phase(
        "add_shard", lambda: cl.add_shard(batch_size=batch))))
    cl.reset_load()
    phase("A_hot_shard0", lambda: run_workload(
        cl, "A", SHARDED_OPS["hot"], cfg, batch_size=batch, hot_shard=0))
    reports.append(("rebalance", phase(
        "rebalance", lambda: cl.rebalance(skew_threshold=1.2,
                                          max_moves=REBALANCE_MOVES,
                                          batch_size=batch))))
    counts["sealed_per_shard_end"] = [sealed_chunks(sh) for sh in cl.shards]
    return reports, secs, counts


def run_sharded(np, torch, testbed):
    """Four paper testbeds as the shards of one ring-placed cluster on the
    card (each shard its own ``CudaEngine``; the scatter runs them on
    worker threads), against a numpy-engine twin."""
    from repro_torch.configs.memec import make_configured_cluster
    from repro_torch.data.ycsb import YCSBConfig, run_workload
    cfg = YCSBConfig(num_objects=SHARDED_OBJECTS, key_size=testbed.key_size,
                     value_sizes=testbed.value_sizes)
    cl = make_configured_cluster(testbed, engine="cuda")
    twin = make_configured_cluster(testbed, engine="numpy")
    log(f"sharded: {testbed.shards} shards x ({testbed.num_servers} servers, "
        f"RS({testbed.n},{testbed.k}), c={testbed.c}, {testbed.chunk_size} B "
        f"chunks), placement {testbed.placement}, {SHARDED_OBJECTS} objects, "
        f"YCSB batch {testbed.batch_size}")
    t0 = time.perf_counter()
    (reports, secs, counts), launches = launched_in(
        torch, lambda: sharded_scenario(cl, cfg, run_workload,
                                        testbed.batch_size))
    wall = time.perf_counter() - t0
    log("sharded cuda seconds per phase:", json.dumps(secs))
    log("sharded cuda launches per kernel:", json.dumps(launches))
    log("sharded chunks:", json.dumps(counts))
    t0 = time.perf_counter()
    twin_reports, twin_secs, twin_counts = sharded_scenario(
        twin, cfg, run_workload, testbed.batch_size)
    twin_wall = time.perf_counter() - t0
    log("sharded numpy twin seconds per phase:", json.dumps(twin_secs))
    log(f"sharded scenario wall seconds: cuda {wall:.3f}, numpy twin "
        f"{twin_wall:.3f}")
    log("sharded reports:", json.dumps(reports, default=str))

    missing = [k for k in SHARDED_KERNELS if launches[k] == 0]
    assert not missing, f"sharded: kernels never launched: {missing}"
    assert all(n > 0 for n in counts["sealed_per_shard_after_load_A"]), \
        f"a shard sealed nothing: {counts}"
    assert reports[0][3]["recovered_chunks"] > 0, "nothing recovered"
    assert reports[2][1]["moved_keys"] > 0, "add_shard moved nothing"
    assert reports[3][1]["moved_keys"] > 0, f"rebalance: {reports[3][1]}"
    for i, eng in enumerate(cl.engines):
        paths = set(eng.op_paths.values())
        assert paths <= {"cuda-kernel"}, f"shard {i} op_paths {eng.op_paths}"
        assert paths or i >= testbed.shards, f"shard {i} ran no coding op"
    assert reports == twin_reports, "fail/restore/migration reports differ"
    assert counts == twin_counts, (counts, twin_counts)
    assert cl.stats == twin.stats, "sharded stats differ from the twin"
    got = contents(cl, cfg, 0)
    assert got == contents(twin, cfg, 0), "contents differ from the twin"
    assert all(v is not None for v in got), "a loaded key is lost"
    for i, sh in enumerate(cl.shards):
        checked, bad = parity_invariant(np, sh)
        log(f"sharded shard {i} parity sweep: {checked} sealed data chunks "
            f"checked, {bad} bad")
        assert bad == 0
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import numpy as np
    from repro_torch.configs.memec import CONFIG
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
    log(f"phase kernels: {time.perf_counter() - t_start:.1f} s since start")
    t0 = time.perf_counter()
    launches, rs_cl = run_cluster(np, torch, CONFIG, RS_KERNELS)
    by_phase = {"rs_cluster": launches}
    probe_row = next(r for r in rows if r["name"] == "gf_cuckoo_probe")
    check_probe_on_index(np, torch, rs_cl, probe_row)
    del rs_cl
    log(f"phase RS cluster: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_phase["rdp_cluster"], _ = run_cluster(
        np, torch, dataclasses.replace(CONFIG, scheme="rdp"), RDP_KERNELS)
    log(f"phase RDP cluster: {time.perf_counter() - t0:.1f} s")
    by_phase["rs_14_10_decode"] = run_wide_decode(np, torch)
    by_phase["ops"] = run_ops(np, torch)
    t0 = time.perf_counter()
    by_phase["sharded"] = run_sharded(np, torch, dataclasses.replace(
        CONFIG, shards=4, placement="ring", batch_size=BATCH))
    log(f"phase sharded: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches_by_phase"] = {p: n[row["name"]]
                                    for p, n in by_phase.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        log(json.dumps({k: row[k] for k in (
            "name", "launches", "launches_by_phase", "ms", "kernel_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "shape")}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
