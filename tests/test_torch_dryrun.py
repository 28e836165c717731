"""``repro_torch.launch.dryrun`` and ``launch/cost_analysis.py`` against the
JAX package's ``launch/dryrun.py`` and ``launch/hlo_analysis.py``.

One subprocess (8 forced host devices; ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when imported) lowers and compiles the reference's cells,
with ``repro.launch.dryrun.get_config`` pointed at ``get_reduced`` in that
process only, while this process counts the port's cells on ``meta``:

1. FLOPs, for starcoder2-3b, recurrentgemma-2b and llama4-maverick (MoE),
   reduced, x train_4k, prefill_32k and decode_32k, on the 1 x 1 host
   mesh (the whole program; on the (4, 2) mesh GSPMD computes some dots
   on every "model" position, which the port's even split does not
   model).  The reference side is the sum of its HLO's ``dot``
   instructions times their loops' trip counts (``analyze``'s ``flops``
   also counts elementwise ops); the port side is ``FlopCounterMode``'s
   count.  They differ only in attention, which the test derives:

   - the reference's blockwise attention computes every (Q tile, KV
     tile) pair of a padded Sq_p x Skv_p, 4·B·H·hd·Sq_p·Skv_p a forward,
     and a training step holds it 4 times (forward, the ``full`` remat's
     recompute, and the backward's two products per forward product);
   - the port's flash route (layer kinds A and M at these lengths) counts
     kernel 11 by its formula, 4·B·H·hd per causal (query, key) pair, in
     the forward and the recompute, and its backward
     (``flash_attention_backward``) 10·B·H·hd·rows·L for each tile of
     ``BWD_BLOCK_Q`` query rows that sees L keys.

   Every other product agrees exactly: tolerance 0 on integers.
2. Argument bytes per device, on the host mesh and on (4, 2), against
   ``compiled.memory_analysis().argument_size_in_bytes``: exact.
3. A rank's count on (4, 2) (``count: "rank"``), for reduced
   starcoder2-3b's, minicpm3-4b's and llama4-maverick's prefill_32k and
   decode_32k (the MLA prefill cut to B 8 x S 256, ``MESH_CUTS``): the
   matrix-product FLOPs of a position times 8 equal the one-device count
   plus what the plan repeats on every "model" position
   (``repeated_products``: K and V, and wq and wo in a decode step;
   MLA's ``w_dkv``, and ``w_uk`` and ``w_uv`` in a prefill, ``w_dq`` in a
   decode step; MoE's router, its experts' products split over the
   positions), and the stripes' attention FLOPs sum to the one-device
   kernel's.  The reference's
   per-device HLO dot FLOPs and collective bytes of starcoder2-3b's
   cells are printed beside the port's (``-s``); the two plans differ
   (PERF.md §6).  Every cell of
   starcoder2-3b, recurrentgemma-2b and llama4-maverick (its experts
   split over "model") on (4, 2), training with the CLI's adamw8bit too,
   counts a rank.
4. The EC pseudo-cells on (4, 2) at the reference's 256 MiB a device:
   each counts one position's rank body (``ecstore.rank_*``), which
   sends the reference's blocks, so argument bytes, collective-permute
   operand bytes and permute counts equal ``analyze``'s for ``update``,
   ``update_chain`` and ``reconstruct``.  Wire bytes: the port counts one
   NVLink hop a permute (wire = operand); ``analyze`` counts torus hops
   by device id.
"""
import importlib
import json
import math
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import subprocess_env
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.kernels import dispatch
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_test_mesh
from repro_torch.models import layers, moe

fa = importlib.import_module("repro_torch.kernels.flash_attention")

ARCHS = ("starcoder2-3b", "recurrentgemma-2b", "llama4-maverick-400b-a17b")
CELLS = [(a, s) for a in ARCHS for s in ("train_4k", "prefill_32k",
                                         "decode_32k")]
EC_OPS = ("update", "update_chain", "reconstruct")
#: cells whose (4, 2) program a rank counts
MESH_CELLS = [("starcoder2-3b", "prefill_32k"), ("starcoder2-3b",
                                                  "decode_32k"),
              ("minicpm3-4b", "prefill_32k"), ("minicpm3-4b", "decode_32k"),
              ("llama4-maverick-400b-a17b", "prefill_32k"),
              ("llama4-maverick-400b-a17b", "decode_32k")]
#: the products each mesh cell's plan repeats on every "model" position
REPEATED = {("starcoder2-3b", "prefill_32k"): {"wk", "wv"},
            ("starcoder2-3b", "decode_32k"): {"wk", "wv", "wq", "wo"},
            ("minicpm3-4b", "prefill_32k"): {"w_dkv", "w_uk", "w_uv"},
            ("minicpm3-4b", "decode_32k"): {"w_dkv", "w_dq"},
            ("llama4-maverick-400b-a17b", "prefill_32k"): {"wk", "wv",
                                                           "router"},
            ("llama4-maverick-400b-a17b", "decode_32k"): {"wk", "wv", "wq",
                                                          "wo", "router"}}
#: mesh cells counted at a cut (batch, seq), on both meshes: reduced
#: minicpm3-4b's prefill at S 32,768 steps through 262,144 (Q, KV) tile
#: pairs of ``_mla_blockwise`` a layer; at S 256 its 32-row stripes have
#: no padding, so the stripes' products add up to the one device's
MESH_CUTS = {("minicpm3-4b", "prefill_32k"): (8, 256)}

REFERENCE = """
import json, re
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.launch.dryrun as dr
from repro.configs import get_reduced
from repro.launch import hlo_analysis as ha
from repro.launch.mesh import make_host_mesh, make_test_mesh
dr.get_config = get_reduced

def dot_flops(text):
    comps = ha.parse_hlo(text)
    memo = {}
    def cost(name, stack=()):
        if name in memo:
            return memo[name]
        if name in stack or name not in comps:
            return 0
        c, tot = comps[name], 0
        for ins in c.instrs:
            if ins.op == "while":
                m = ha._TRIP_RE.search(ins.attrs)
                b = ha._BODY_RE.search(ins.attrs)
                if b:
                    tot += (int(m.group(1)) if m else 1) * cost(
                        b.group(1), stack + (name,))
                continue
            if ins.op == "dot":
                relems, _ = ha._shape_elems_bytes(ins.result_type)
                ld = ha._dims(c.shapes.get(ins.operands[0], ""))
                cm = ha._CONTRACT_RE.search(ins.attrs)
                k = 1
                for i in (cm.group(1).split(",") if cm and cm.group(1)
                          else []):
                    k *= ld[int(i)]
                tot += 2 * relems * k
                continue
            for rx in (ha._CALLS_RE, ha._TOAPPLY_RE):
                for mm in rx.finditer(ins.attrs):
                    tot += cost(mm.group(1), stack + (name,))
            mb = ha._BRANCH_RE.search(ins.attrs)
            if mb:
                subs = re.findall(r"%([\\w\\.\\-]+)", mb.group(1))
                tot += max([cost(s, stack + (name,)) for s in subs] or [0])
        memo[name] = tot
        return tot
    return cost(comps["__entry__"].name)

def compiled(step, args, in_sh, out_sh, mesh):
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    with mesh:
        return jax.jit(step, in_shardings=named(in_sh),
                       out_shardings=named(out_sh)).lower(*args).compile()

out = {"cells": {}, "ec": {}}
for arch, shape in CELLS:
    row = {}
    for name, mesh in (("host", make_host_mesh()),
                       ("4x2", make_test_mesh(4, 2))):
        (step, args, in_sh, out_sh, meta), _ = dr.build_cell(
            arch, shape, mesh, optimizer="adamw8bit", remat="full")
        comp = compiled(step, args, in_sh, out_sh, mesh)
        row[name + "_args"] = comp.memory_analysis().argument_size_in_bytes
        if name == "host":
            row["dot_flops"] = dot_flops(comp.as_text())
        elif (arch, shape) in MESH_CELLS:
            a = ha.analyze(comp.as_text())
            row["4x2_dot_flops"] = dot_flops(comp.as_text())
            row["4x2_collective_bytes"] = a["collective_op_bytes"]
            row["4x2_collective_wire"] = a["collective_wire_bytes"]
    out["cells"][arch + "/" + shape] = row
mesh = make_test_mesh(4, 2)
for op in EC_OPS:
    step, args, in_sh, out_sh, meta = dr.build_ec_cell(mesh, op=op)
    comp = compiled(step, args, in_sh, out_sh, mesh)
    a = ha.analyze(comp.as_text())
    out["ec"][op] = {
        "operand": a["collective_op_bytes"].get("collective-permute", 0),
        "wire": a["collective_wire_bytes"].get("collective-permute", 0),
        "count": a["collective_counts"].get("collective-permute", 0),
        "args": comp.memory_analysis().argument_size_in_bytes}
print(json.dumps(out))
"""


def _port_cells() -> dict:
    out = {}
    for arch, shape in CELLS:
        row = {"host": dryrun.run_cell(arch, shape, "host")}
        cfg = get_reduced(arch).scaled(remat="full")
        with dispatch.dry_run():
            cell = dryrun.build_cell(cfg, SHAPES[shape], make_test_mesh(4, 2))
        row["4x2_args"] = ca.argument_bytes(cell.args, make_test_mesh(4, 2))
        row["4x2"] = dryrun.run_cell(arch, shape, make_test_mesh(4, 2))
        out[f"{arch}/{shape}"] = row
    for arch, shape in MESH_CELLS:
        if (arch, shape) in CELLS:
            continue
        batch, seq = MESH_CUTS.get((arch, shape), (None, None))
        out[f"{arch}/{shape}"] = {
            mesh: dryrun.run_cell(arch, shape, mesh if mesh == "host"
                                  else make_test_mesh(4, 2), batch=batch,
                                  seq=seq) for mesh in ("host", "4x2")}
    out["ec"] = {op: dryrun.run_cell("ecstore", op, make_test_mesh(4, 2))
                 for op in EC_OPS}
    return out


@pytest.fixture(scope="module")
def both():
    """(port, reference) results; the reference compiles in a subprocess
    while the port counts here."""
    env = subprocess_env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    code = (f"CELLS = {CELLS!r}\nEC_OPS = {EC_OPS!r}\n"
            f"MESH_CELLS = {MESH_CELLS!r}\n" + textwrap.dedent(REFERENCE))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        saved = dryrun.get_config
        dryrun.get_config = get_reduced
        try:
            port = _port_cells()
        finally:
            dryrun.get_config = saved
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return port, json.loads(out.strip().splitlines()[-1])


def _attention(cfg, shape, n_calls_per_layer, flash_count):
    """(port, reference) attention FLOPs of the flash-route layers of a
    cell (module notes)."""
    B, S = shape.global_batch, shape.seq_len
    H, hd = cfg.num_heads, cfg.head_dim
    per_call = fa.flash_flops((B, S, H, hd), (B, S), True)
    assert flash_count % (n_calls_per_layer * per_call) == 0
    n_layers = flash_count // (n_calls_per_layer * per_call)
    bq = min(cfg.attn_block_q, max(S, 16))
    bkv = min(cfg.attn_block_kv, S)
    Sq_p, Skv_p = -(-S // bq) * bq, -(-S // bkv) * bkv
    ref = n_layers * (16 if shape.kind == "train" else 4) \
        * B * H * hd * Sq_p * Skv_p
    port = flash_count
    if shape.kind == "train":
        T = fa.BWD_BLOCK_Q
        tiles = sum((min(S, s0 + T) - s0) * min(S, s0 + T)
                    for s0 in range(0, S, T))
        port += n_layers * 10 * B * H * hd * tiles
    return n_layers, port, ref


@pytest.mark.parametrize("arch,shape", CELLS)
def test_matmul_flops_equal_reference(both, arch, shape):
    port, ref = both
    cell = port[f"{arch}/{shape}"]["host"]
    want = ref["cells"][f"{arch}/{shape}"]["dot_flops"]
    cfg = get_reduced(arch)
    spec = SHAPES[shape]
    flash = cell["flops_by_op"].get("repro_torch.flash_attention", 0)
    n_layers, port_attn, ref_attn = _attention(
        cfg, spec, 2 if spec.kind == "train" else 1, flash)
    flash_kinds = sum(k in "AM" for k in cfg.layers)
    assert n_layers == (flash_kinds if spec.kind != "decode" else 0)
    assert cell["flops_total"] - port_attn == want - ref_attn, (
        cell["flops_by_op"], want, port_attn, ref_attn)
    assert cell["flops_per_device"] == cell["flops_total"]


@pytest.mark.parametrize("mesh", ("host", "4x2"))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_reference(both, arch, shape, mesh):
    port, ref = both
    row = port[f"{arch}/{shape}"]
    got = (row["host"]["argument_bytes_per_device"] if mesh == "host"
           else row["4x2_args"])
    assert got == ref["cells"][f"{arch}/{shape}"][f"{mesh}_args"]


def _mm(flops_by_op) -> int:
    return sum(v for k, v in flops_by_op.items()
               if k != "repro_torch.flash_attention")


@pytest.mark.parametrize("arch,shape", MESH_CELLS)
def test_mesh_cell_counts_a_rank(both, arch, shape):
    """A (4, 2) prefill or decode cell of a dense or MoE arch reports a
    rank's count: a position's matrix-product FLOPs times 8 equal the
    one-device count plus the products the plan repeats on the other M - 1
    "model" positions of each of the A data positions; the stripes' kernel-11
    FLOPs times A sum to the one-device kernel's.  The reference's
    per-device HLO numbers are printed beside (module notes)."""
    port, ref = both
    row = port[f"{arch}/{shape}"]
    cell, host = row["4x2"], row["host"]
    A, M = 4, 2
    assert cell["count"] == "rank" and host["count"] == "even split"
    assert len(cell["positions"]) == M
    assert set(cell["repeated_products"]) == REPEATED[arch, shape]
    rank_mm = _mm(cell["flops_by_op"])
    assert rank_mm * A * M == _mm(host["flops_by_op"]) + (M - 1) * A * sum(
        cell["repeated_products"].values())
    attn = [p["flops"] - rank_mm for p in cell["positions"]]
    assert A * sum(attn) == host["flops_by_op"].get(
        "repro_torch.flash_attention", 0)
    assert cell["flops_total"] == A * sum(p["flops"]
                                          for p in cell["positions"])
    assert cell["collectives"]["all-gather"] > 0
    assert cell["collectives"]["all-reduce"] > 0
    assert cell["collective_bytes_per_device"] == sum(
        cell["collectives"].values())
    want = ref["cells"].get(f"{arch}/{shape}")
    if want is None:                    # the reference compiles CELLS only
        return
    print(json.dumps({"cell": f"{arch}/{shape} reduced, (4, 2)",
                      "port_flops_per_device": cell["flops_per_device"],
                      "port_matmul_flops_per_device": rank_mm,
                      "port_collective_bytes": cell["collectives"],
                      "reference_dot_flops_per_device":
                          want["4x2_dot_flops"],
                      "reference_collective_operand_bytes":
                          want["4x2_collective_bytes"],
                      "reference_collective_wire_bytes":
                          want["4x2_collective_wire"]}))


def test_training_and_other_archs_keep_the_even_split(both):
    """On (4, 2) every cell counts a rank - training with the CLI's
    adamw8bit included, recurrentgemma-2b's RG-LRU layers and the MoE
    arch's experts too - with all-gather and all-reduce bytes (an MoE
    layer's all-reduce over "model" sums its experts' partial outputs),
    the MoE cells naming the router among the products every model
    position repeats; only the 1 x 1 mesh keeps the even split."""
    port, _ = both
    for arch, shape in CELLS:
        cell = port[f"{arch}/{shape}"]["4x2"]
        assert cell["count"] == "rank", (arch, shape)
        assert cell["collectives"]["all-gather"] > 0
        assert cell["collectives"]["all-reduce"] > 0
        assert "not ported" not in cell["collective_note"]
        assert port[f"{arch}/{shape}"]["host"]["count"] == "even split"
        if arch == "llama4-maverick-400b-a17b":
            assert cell["repeated_products"]["router"] > 0


@pytest.mark.parametrize("op", EC_OPS)
def test_ec_collectives(both, op):
    """Every EC cell counts one device's rank body, which sends the
    reference's blocks: argument bytes, collective-permute operand bytes
    and the number of permutes equal ``analyze``'s, and the bytes follow
    the reference's formulas (m*k blocks for ``update``, k*m + m(m-1)/2
    for ``update_chain``, (A - 1)*k for ``reconstruct``)."""
    port, ref = both
    cell, want = port["ec"][op], ref["ec"][op]
    k, m, A = 8, 2, 4
    block = (1 << 28) // 4096 // k * 4096               # S pages of a class
    assert cell["argument_bytes_per_device"] == want["args"]
    got = cell["collectives"]["collective-permute"]
    assert cell["collective_wire"]["collective-permute"] == got
    assert got == want["operand"]
    assert cell["collective_counts"]["collective-permute"] == want["count"]
    blocks = {"update": m * k, "update_chain": k * m + m * (m - 1) // 2,
              "reconstruct": (A - 1) * k}[op]
    assert got == blocks * block
    assert want["count"] == blocks


def test_cli_full_config_and_skips(tmp_path):
    """The CLI at full width: one cell counted, a sub-quadratic shape
    skipped with its reason, every record written."""
    for shape in ("decode_32k", "long_500k"):
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "starcoder2-3b", "--shape", shape, "--mesh", "single",
             "--out", str(tmp_path)], env=subprocess_env(),
            capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
    ok = json.loads((tmp_path / "starcoder2-3b__decode_32k__single.json")
                    .read_text())
    assert ok["status"] == "ok" and ok["devices"] == 256
    # a dense arch's decode cell on 16 x 16 counts a rank's forward
    assert ok["count"] == "rank" and len(ok["positions"]) == 16
    assert ok["collective_bytes_per_device"] == sum(
        ok["collectives"].values()) > 0
    assert "one rank" in ok["collective_note"]
    assert ok["bottleneck"] in ("compute", "memory", "collective")
    assert ok["extrapolated_from"] == [1, 2]
    skip = json.loads((tmp_path / "starcoder2-3b__long_500k__single.json")
                      .read_text())
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]


def test_depth_extrapolation_is_exact():
    """Counting at 1 and 2 repeats and extrapolating gives the FLOPs and
    bytes of the whole depth (4 repeats, reduced starcoder2-3b, train);
    the peak moves within the step as depth grows, so its extrapolation
    is only flagged as one."""
    cfg = get_reduced("starcoder2-3b").scaled(num_layers=4)
    shape = dryrun.cell_shape("train_4k", batch=2, seq=64)
    mesh = make_host_mesh()
    with dispatch.dry_run():
        whole = dryrun.count_cell(cfg, shape, mesh, "adamw")
        est = dryrun.count_model_cell(cfg, shape, mesh, "adamw")
    assert est["extrapolated_from"] == [1, 2]
    assert est["flops"] == whole["flops"]
    assert est["bytes"] == whole["bytes"]
    assert est["peak"] > 0 and whole["peak"] > 0


def test_meta_only_inside_the_dry_run():
    """``meta`` passes dispatch only inside ``dry_run``, and a dry run
    leaves the route and drop counters as they were."""
    with pytest.raises(ValueError):
        dispatch.decide(torch.device("meta"))
    with pytest.raises(ValueError):
        dispatch.resolve_device("meta")
    layers.reset_op_paths()
    moe.reset_drops()
    layers.OP_PATHS["x"] = 1
    saved = dryrun.get_config
    dryrun.get_config = get_reduced
    try:
        dryrun.run_cell("llama4-maverick-400b-a17b", "prefill_32k", "host",
                        batch=2, seq=64)
    finally:
        dryrun.get_config = saved
    assert dict(layers.OP_PATHS) == {"x": 1} and moe.DROPS == {}
    layers.reset_op_paths()


def test_cost_analysis_counts_bytes_and_peak():
    """Bytes: every op's operands and results, views free; peak: the live
    storages' bytes."""
    with dispatch.dry_run():
        a = torch.empty((256, 256), device="meta")         # 256 KiB
        with ca.Count([a]) as c:
            b = a * 2                                      # reads a, writes b
            v = b.view(-1)                                 # free
            del b, v
            d = a.sum()                                    # reads a, 4 bytes
    assert c.bytes == 3 * a.nbytes + 4
    assert c.peak_bytes == 2 * a.nbytes
    assert c.flops == 0 and d.shape == ()
    x = torch.empty((2, 64, 32), device="meta")
    with ca.Count() as c:
        torch.bmm(x, x.transpose(1, 2))
    assert c.flops == 2 * 2 * 64 * 64 * 32


def test_recording_counts_only_its_own_thread():
    """A count sees the moves its thread makes, not those another thread
    (a sharded cluster's worker) makes at the same time."""
    import threading

    from repro_torch.distributed import collectives
    x = torch.zeros((4, 1024), dtype=torch.uint8)
    seen = []
    with collectives.recording(lambda n, kind: seen.append(n)):
        worker = threading.Thread(target=collectives.ring_shift, args=(x, 1))
        worker.start()
        worker.join()
        assert seen == []
        collectives.ring_shift(x, 1)
        collectives.ring_shift(x, 4)              # a full turn moves nothing
    collectives.ring_shift(x, 1)                  # outside the context
    assert seen == [x.numel()]


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("arch", ("qwen2-vl-7b", "musicgen-medium"))
def test_embeddings_archs_count_a_rank(arch, kind):
    """The embeddings-input archs' prefill and decode cells on (4, 2)
    count a rank: ``count_rank_forward``'s bytes by kind equal the sends
    ``collectives.recording`` notes while ``RankModel`` runs the same
    inputs on counting communicators; an embeddings input looks up no
    table, so its all-reduces are the token input's less the lookup's,
    2(M - 1)/M of the rows' activations."""
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.ranks import counting_comms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.ranked import RankModel
    cfg = get_reduced(arch)
    mesh = make_mesh((4, 2), ("data", "model"))
    A, M, B, S = 4, 2, 8, 64
    shape = dryrun.ShapeSpec("x", kind, S, B)
    assert dryrun.rank_counted(cfg, shape, mesh)
    coords = (1, 1)
    with dispatch.dry_run():
        got = dryrun.count_rank_forward(cfg, shape, mesh, coords)
        tokens = dryrun.count_rank_forward(
            cfg.scaled(input_mode="tokens"), shape, mesh, coords)
        local, _ = dryrun._rank_blocks(cfg, mesh, coords)
        model = RankModel(cfg, local, counting_comms(mesh, coords))
        batch = dryrun.make_inputs(cfg, shape, "meta")
        sent = {}
        with recording(lambda n, k: sent.__setitem__(k, sent.get(k, 0) + n)):
            if kind == "prefill":
                model.apply(batch)
            else:
                model.decode_step(model.init_cache(B, S), batch["tokens"],
                                  S - 1, batch.get("positions"))
    assert got["collectives"] == sent
    rows, steps = B // A, S if kind == "prefill" else 1
    lookup = 2 * (M - 1) * rows * steps * cfg.d_model * 2 // M   # bf16
    assert tokens["collectives"]["all-reduce"] - \
        got["collectives"]["all-reduce"] == lookup
    assert tokens["collectives"]["all-gather"] > \
        got["collectives"]["all-gather"]      # the table's gather too


@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_meshes_count_every_cell_by_rank(multi_pod):
    """On the production meshes (16 x 16 and 2 x 16 x 16) the rank path
    refuses no cell of any arch: minicpm3-4b's 40 MLA heads need not
    split over the 16 model positions (``ranked.check_config``)."""
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert get_config("minicpm3-4b").num_heads % mesh.shape["model"]
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            assert dryrun.rank_refusal(get_config(arch),
                                       dryrun.cell_shape(shape), mesh) \
                is None, (arch, shape)


def test_minicpm3_decode_counts_a_rank_on_the_production_mesh(monkeypatch):
    """minicpm3-4b's decode_32k on 16 x 16 counts a rank (8 batch rows,
    2,048 of the 32,768 cache slots), its 40 heads whole on every model
    position: the model column's only all-gather a layer is the
    partials', (8, 40, 1, r + 2) fp32 (330,240 B, counted as its 15
    copies), and its all-reduces are (8, 1, 2,560) bf16, two a layer
    (attention and MLP) and the embedding's; with the data column's
    parameter gathers they add up to the cell's bytes by kind."""
    import _model_rank_worker
    from repro_torch.distributed import ranks
    from repro_torch.distributed.ranks import GATHER, REDUCE
    from repro_torch.launch.mesh import make_production_mesh
    res = dryrun.run_cell("minicpm3-4b", "decode_32k", "single")
    assert res["count"] == "rank"
    assert res["collectives"]["all-gather"] > 0
    assert res["collectives"]["all-reduce"] > 0
    cfg = dryrun.get_config("minicpm3-4b")
    shape = dryrun.cell_shape("decode_32k")
    coords = tuple(res["busiest_position"])
    made = []

    def recorded(mesh, at):
        made.append(ranks.AxisComms(
            _model_rank_worker.ShapeComm(mesh, at, "data"),
            _model_rank_worker.ShapeComm(mesh, at, "model")))
        return made[-1]
    monkeypatch.setattr(dryrun, "counting_comms", recorded)
    mesh = make_production_mesh()
    with dispatch.dry_run():
        got = dryrun.count_rank_forward(cfg, shape, mesh, coords)
    comms, = made
    n, M = cfg.num_layers, 16
    rows, r = shape.global_batch // 16, cfg.kv_lora_rank
    partials = ((rows, cfg.num_heads, 1, r + 2), torch.float32)
    assert rows == 8 and comms.model.gathered == [partials] * n
    assert 8 * 40 * 258 * 4 == 330240
    assert comms.model.reduced == [((rows, 1, cfg.d_model),
                                    torch.bfloat16)] * (2 * n + 1)

    def nbytes(shape, dtype):
        return math.prod(shape) * dtype.itemsize
    gathers = (M - 1) * sum(nbytes(*x) for x in comms.model.gathered
                            + comms.data.gathered)
    reduces = sum(2 * (M - 1) * nbytes(*x) // M for x in comms.model.reduced)
    assert comms.data.reduced == []
    assert got["collectives"] == {GATHER: gathers, REDUCE: reduces}
    assert res["collectives"]["all-gather"] == gathers
    assert res["collectives"]["all-reduce"] == reduces == 125 * 76800
    print(json.dumps({"cell": "minicpm3-4b/decode_32k, 16 x 16",
                      "collectives": res["collectives"],
                      "partials_gather_counted": n * (M - 1) * 330240,
                      "repeated_products": res["repeated_products"]}))


def test_counting_comm_follows_gradients_through_a_column_of_one():
    """On a (1, 2) mesh a parameter's data gather (a column of one rank)
    is a copy that autograd follows, as ``RankComm``'s is, so the count
    of a backward reaches the moves beyond it: the model gather's
    reduce-scatter and the model column's gradient sum."""
    from repro_torch.distributed import ranks
    from repro_torch.distributed.collectives import recording
    from repro_torch.launch.mesh import make_mesh
    comms = ranks.counting_comms(make_mesh((1, 2), ("data", "model")),
                                 (0, 1))
    w = torch.ones((4, 3), requires_grad=True)
    sent = {}
    with recording(lambda n, k: sent.__setitem__(k, sent.get(k, 0) + n)):
        block = ranks.all_gather(comms.data, ranks.sum_grad(comms.model, w))
        whole = ranks.all_gather(comms.model, block[0])
        assert block.requires_grad and whole.shape == (2, 4, 3)
        whole.sum().backward()
    assert w.grad is not None
    assert sent == {"all-gather": 48, "reduce-scatter": 48,
                    "all-reduce": 48}
