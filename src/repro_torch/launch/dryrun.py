"""Dry run of every (arch x shape x mesh) cell: the counterpart of the JAX
package's ``launch/dryrun.py``.

The reference lowers and compiles each cell's step over a fleet mesh of
virtual devices and reads XLA's memory and cost analyses.  The port has
no compiler to ask: it builds the cell's model, optimizer state and
inputs on the ``meta`` device (``kernels.dispatch.dry_run``: nothing is
allocated), runs the step there once and counts it
(``launch/cost_analysis.py``): matrix-product FLOPs, bytes of every op,
the peak of live bytes, the bytes moved between mesh positions, and the
argument bytes each device of the mesh holds under
``distributed/sharding.py``'s specs.

* A cell's repeated layer unit is run at 1 and at 2 repeats and the
  counts extrapolated to the config's depth: every repeat is the same
  program, so FLOPs and bytes extrapolate exactly; the arguments are
  counted at full depth.  The peak's place in a training step moves with
  depth, so its extrapolation is an estimate (``peak_extrapolated``);
  ``count_cell`` counts one depth whole.
* The prefill, decode and train cells of every arch (the rank path
  runs every layer kind: "A", "W", "L", "R", "S" and "M") on a (data,
  model) or (pod, data, model) mesh of more than one position count one
  rank's forward
  (``models/ranked.py``'s ``RankModel`` on the position's blocks, its
  moves counted by ``ranks.counting_comms``), or one rank's train step
  with any of the three optimizers (``count_rank_train``; adamw8bit, the
  CLI's default as the reference's, and adafactor add their statistics'
  all-reduces and adamw8bit its codes' all-gathers), at every model
  position (their attention stripes and heads differ) and every (pod,
  data) position whose batch rows differ: per device, the busiest
  position's FLOPs, bytes, peak and collective bytes by kind (``count:
  "rank"``); the totals sum the positions; ``repeated_products`` names
  the matrix products every model position computes alike and their
  FLOPs on one position.  A batch at or above its axes' size that they
  do not divide, or a head or expert count that "model" does not divide
  (a Mamba-2 or MoE layer's; ``ranked.check_config``), keeps the even
  split: no cell of the production meshes does (an MLA layer's heads
  need not split: ``models/ranked.py``).
* Every other model cell (the 1 x 1 mesh, and the cells above that the
  rank path refuses) runs its positions as one program
  on one card: FLOPs and bytes per device are the program's divided by
  the devices (an even split, ``count: "even split"``), the peak is
  given for one card running the whole program, and there are no
  collectives (their fields are null, with the reason).
* An EC cell runs one device's program: the rank body of one position
  (``distributed/ranks.py``, ``ecstore.rank_*``) on its own block, so its
  counts and peak are a device's, and its sends, counted by a
  ``CountingComm``, are the reference's ``collective-permute``s.
* Roofline terms use the H100 SXM data sheet: 989 TFLOP/s bf16 dense,
  3.35 TB/s HBM3, and 450 GB/s of NVLink each way per card, which holds
  only between cards of one NVLink domain (every permute one hop, as
  the domain's switch connects all pairs).  They are counts and data-sheet
  terms, not measurements.

Special pseudo-arch ``ecstore``: the MemEC parity delta update (``update``,
``update_chain``) and the decode-from-k reconstruction (``reconstruct``)
over the mesh, the paper's own technique as a cell.

Run: ``python -m repro_torch.launch.dryrun [--arch A[,A...]] [--shape
S[,S...]] [--mesh single|multi|both] [--optimizer adamw8bit] [--remat
full] [--attn ...] [--kv ...] [--tag T] [--out DIR]``: one JSON file a
cell in ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time

import torch

from ..configs import ARCH_NAMES, get_config
from ..configs.shapes import SHAPES, ShapeSpec, input_specs, shape_applicable
from ..distributed import sharding as shd
from ..distributed.ecstore import (ECConfig, rank_parity_delta_update,
                                   rank_parity_delta_update_chain,
                                   rank_reconstruct_failed)
from ..train.checkpoint import ECCheckpoint
from ..distributed.ranks import CountingComm, counting_comms
from ..kernels import dispatch
from ..models import Model, layers, moe
from ..models.convert import param_tree
from ..models.ranked import (MESH_AXES, RankModel, batch_rows,
                             check_config)
from ..tree import Stacked, leaves, tree_map
from ..train.optimizer import Blocks, make_optimizer
from ..train.train_step import make_rank_train_step, make_train_step
from . import cost_analysis as ca
from .mesh import Mesh, make_host_mesh, make_production_mesh

# NVIDIA H100 SXM data sheet (roofline terms)
PEAK_FLOPS = 989e12        # bf16 dense FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # bytes/s each way per card, within one NVLink domain

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
NO_SPMD = ("no SPMD collectives: the mesh's positions run as one program "
           "on one card, its counts split evenly")
RANK_NOTE = ("one rank's forward or train step, the busiest position's: "
             "the bytes it sends by kind (an all-gather or a reduce-scatter "
             "(A - 1) blocks, an all-reduce 2(A - 1)/A of its bytes, the "
             "ring's share)")


def _mesh(mesh) -> Mesh:
    if isinstance(mesh, Mesh):
        return mesh
    if mesh == "host":
        return make_host_mesh()
    return make_production_mesh(multi_pod=(mesh == "multi"))


def _mesh_name(mesh: Mesh) -> str:
    return {(16, 16): "single", (2, 16, 16): "multi"}.get(
        tuple(mesh.axis_sizes), "x".join(map(str, mesh.axis_sizes)))


@contextlib.contextmanager
def _counters_kept():
    """The dry run's calls leave ``OP_PATHS`` and ``DROPS`` as they were."""
    paths, drops = dict(layers.OP_PATHS), dict(moe.DROPS)
    try:
        yield
    finally:
        layers.OP_PATHS.clear()
        layers.OP_PATHS.update(paths)
        moe.DROPS.clear()
        moe.DROPS.update(drops)


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """A built cell: ``step()`` runs it once; ``args`` are the (tree,
    specs) pairs of its arguments; ``model`` its model."""
    step: object
    args: list
    model: Model
    meta: dict

    def tensors(self) -> list:
        """The argument tensors on the model's device (an optimizer's step
        count lives on the host)."""
        dev = self.model.device
        return [t for tree, _ in self.args for leaf in leaves(tree)
                for t in (leaf.parts if isinstance(leaf, Stacked) else [leaf])
                if isinstance(t, torch.Tensor) and t.device == dev]

    def device_bytes(self) -> int:
        """Bytes of the arguments' storages on the model's device (what
        the card's allocator is asked for: ``requested_bytes``)."""
        return ca.storage_bytes(self.tensors())


def make_inputs(cfg, shape: ShapeSpec, device, generator=None) -> dict:
    """The cell's inputs: meta tensors, or random token ids (and
    embeddings, positions) on ``device`` from ``generator``."""
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if torch.device(device).type == "meta" or name == "cur_len":
            out[name] = spec.meta() if name != "cur_len" else \
                torch.tensor(shape.seq_len - 1, dtype=spec.dtype)
        elif spec.dtype.is_floating_point:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=device).to(spec.dtype)
        elif name == "positions":
            S = spec.shape[-1]
            out[name] = torch.arange(S, device=device, dtype=spec.dtype) \
                .expand(spec.shape).contiguous()
        else:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=generator, device=device,
                                      dtype=spec.dtype)
    return out


def cell_shape(shape_name: str, batch: int | None = None,
               seq: int | None = None) -> ShapeSpec:
    """The named shape, with its batch and sequence cut when given."""
    shape = SHAPES[shape_name]
    return dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                               seq_len=seq or shape.seq_len)


def build_cell(cfg, shape: ShapeSpec, mesh: Mesh, *, optimizer="adamw8bit",
               device="meta", generator=None) -> Cell:
    """The cell's model, state, inputs and step on ``device`` (``meta``
    inside ``dispatch.dry_run``, or the card, with random weights from
    ``generator``)."""
    model = Model(cfg, device=device)
    if torch.device(device).type != "meta":
        model.init(generator)
    params = param_tree(model)
    batch = make_inputs(cfg, shape, device, generator)
    pspecs = shd.param_specs(cfg, params, mesh)
    bspecs = shd.batch_specs(cfg, batch, mesh)
    meta = {"params": sum(math.prod(x.shape) for x in leaves(params)),
            "model_params": cfg.param_count(),
            "active_params": cfg.active_param_count()}
    if shape.kind == "train":
        opt = make_optimizer(optimizer, total_steps=10000)
        opt_state = opt.init(params)
        train = make_train_step(model, opt)
        ospecs = _opt_specs(opt_state, pspecs, mesh)

        def step():
            return train(params, opt_state, batch)
        return Cell(step, [(params, pspecs), (opt_state, ospecs),
                           (batch, bspecs)], model, meta)
    if shape.kind == "prefill":
        return Cell(lambda: model.apply(batch), [(params, pspecs),
                                                 (batch, bspecs)], model, meta)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             dtype=torch.bfloat16)
    cspecs = shd.cache_specs(cfg, model.cache_tree(cache), mesh)

    def serve():
        return model.decode_step(cache, batch["tokens"], shape.seq_len - 1,
                                 batch.get("positions"))
    return Cell(serve, [(params, pspecs), (model.cache_tree(cache), cspecs),
                        (batch, bspecs)], model, meta)


def _opt_specs(opt_state, pspecs, mesh) -> dict:
    """The reference's ``_opt_specs``: moments (keys m, v, f) take their
    parameter's spec where the ranks agree; quantized {q, s} moments and
    everything else are replicated."""
    def rec(o, p=None):
        if isinstance(o, dict):
            if set(o) == {"q", "s"}:
                return {"q": shd.P(), "s": shd.P()}
            return {k: rec(v, p.get(k) if isinstance(p, dict) else None)
                    for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(rec(v, p[i] if isinstance(p, (list, tuple))
                               and i < len(p) else None)
                           for i, v in enumerate(o))
        if o is None:
            return None
        if isinstance(p, shd.P) and len(p) == len(o.shape):
            return shd.fit_spec(p, o.shape, mesh)
        return shd.P()
    return {k: rec(v, pspecs) if k in ("m", "v", "f") else rec(v)
            for k, v in opt_state.items()}


def build_ec_cell(mesh: Mesh, *, bytes_per_device: int = 1 << 28,
                  op: str = "update"):
    """The MemEC parity collectives over the mesh, as one device runs
    them: the rank body of mesh position 0 (``ecstore.rank_*``) on its
    own ``bytes_per_device`` of protected state (default 256 MiB, as the
    reference) and its parity, on ``meta``, its moves counted by a
    ``ranks.CountingComm``.  Returns (step, args, meta)."""
    cfg = ECConfig()
    pages_local = bytes_per_device // cfg.page_size
    pages_local -= pages_local % cfg.k
    S = pages_local // cfg.k
    comm = CountingComm(mesh, (0,) * len(mesh.axis_names), cfg.axis)
    state = torch.empty((pages_local, cfg.page_size), dtype=torch.uint8,
                        device="meta")
    parity = torch.empty((cfg.m, S, cfg.page_size), dtype=torch.uint8,
                         device="meta")
    if op == "reconstruct":
        def step():
            return rank_reconstruct_failed(state, parity, 3, cfg, comm)
    else:
        upd = (rank_parity_delta_update_chain if op == "update_chain"
               else rank_parity_delta_update)

        def step():
            return upd(state, parity, cfg, comm)
    # one position's block, whole on its device
    args = [(state, shd.P()), (parity, shd.P())]
    meta = {"bytes_per_device": bytes_per_device,
            "ec": f"RS({cfg.n},{cfg.k})"}
    return step, args, meta


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def count_cell(cfg, shape, mesh, optimizer="adamw8bit") -> dict:
    """Run the cell once on meta (inside ``dispatch.dry_run``) at the
    config's depth and count it."""
    cell = build_cell(cfg, shape, mesh, optimizer=optimizer)
    with ca.Count(cell.tensors()) as c:
        cell.step()
    return {"flops": c.flops, "bytes": c.bytes, "peak": c.peak_bytes,
            "flops_by_op": c.flops_by_op}


def _depth(cfg, repeats: int):
    unit = len(cfg.layer_pattern)
    tail = cfg.num_layers % unit
    return cfg.scaled(num_layers=repeats * unit + tail)


def _extrapolate(one, two, R: int):
    """one + (R - 1)(two - one) over numbers and dicts of them."""
    if isinstance(one, dict) or isinstance(two, dict):
        return {k: _extrapolate(one.get(k, 0), two.get(k, 0), R)
                for k in set(one) | set(two)}
    return one + (R - 1) * (two - one)


def count_model_cell(cfg, shape: ShapeSpec, mesh: Mesh,
                     optimizer="adamw8bit", count=None) -> dict:
    """Counts of the cell at the config's full depth: run at 1 and 2
    repeats of the layer unit and extrapolated (a config of at most 2
    repeats runs as it is).  ``count(cfg)``: one count at a depth
    (default ``count_cell``)."""
    if count is None:
        def count(c):
            return count_cell(c, shape, mesh, optimizer)
    R = cfg.num_layers // len(cfg.layer_pattern)
    if R <= 2:
        out = count(cfg)
        out["extrapolated_from"] = None
        return out
    one, two = count(_depth(cfg, 1)), count(_depth(cfg, 2))
    out = {k: _extrapolate(one[k], two[k], R) for k in one}
    out["extrapolated_from"] = [1, 2]
    return out


def rank_refusal(cfg, shape: ShapeSpec, mesh: Mesh) -> str | None:
    """Why the cell keeps the even split: None where it counts one rank's
    forward or train step (module notes), "" on a 1 x 1 or other mesh,
    else the rank path's refusal."""
    if mesh.size == 1 or tuple(mesh.axis_names) not in MESH_AXES:
        return ""
    try:
        batch_rows(shape.global_batch, mesh.shape["data"], 0,
                   mesh.shape.get("pod", 1))
        check_config(cfg, mesh)
    except ValueError as e:
        return str(e)
    return None


def rank_counted(cfg, shape: ShapeSpec, mesh: Mesh) -> bool:
    """Whether the cell counts one rank's forward or train step."""
    return rank_refusal(cfg, shape, mesh) is None


def _rank_blocks(cfg, mesh: Mesh, coords):
    """Fresh ``meta`` tensors of the blocks the rank at ``coords`` holds,
    and the list of them."""
    def fresh(x):
        if isinstance(x, Stacked):
            return Stacked(fresh(p) for p in x.parts)
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    params = param_tree(Model(cfg, device="meta"))
    specs = shd.param_specs(cfg, params, mesh)
    local = tree_map(lambda leaf, spec: fresh(shd.local_block(
        leaf, spec, mesh, coords)), params, specs)
    return local, _tensors(local)


def _tensors(tree) -> list:
    return [t for leaf in leaves(tree) for t in (
        leaf.parts if isinstance(leaf, Stacked) else [leaf])
        if isinstance(t, torch.Tensor)]


def _rank_count(c, model) -> dict:
    return {"flops": c.flops, "bytes": c.bytes, "peak": c.peak_bytes,
            "flops_by_op": c.flops_by_op,
            "collectives": dict(c.collective_bytes),
            "collective_counts": dict(c.collective_counts),
            "repeated": dict(model.repeated)}


def count_rank_train(cfg, shape: ShapeSpec, mesh: Mesh, coords,
                     optimizer: str = "adamw", ec: ECConfig | None = None
                     ) -> dict:
    """One train step of the rank at ``coords`` on ``meta``
    (``train_step.make_rank_train_step``: forward, the remat recompute,
    backward, the gradient sums, the norm, ``optimizer`` on the blocks;
    with ``ec``, the ``ECCheckpoint(comm=...)`` stage and commit of the
    rank's blocks), its moves counted by ``ranks.counting_comms``: what
    ``count_rank_forward`` reports; ``OP_PATHS`` and ``DROPS`` are left
    as they were.  Call inside ``dispatch.dry_run``."""
    local, live = _rank_blocks(cfg, mesh, coords)
    comms = counting_comms(mesh, coords)
    model = RankModel(cfg, local, comms)
    params = model.params
    opt = make_optimizer(optimizer, total_steps=10000)
    opt_state = opt.init(params, place=Blocks(model.specs, comms))
    batch = make_inputs(cfg, shape, "meta")
    live += _tensors(opt_state) + list(batch.values())
    ec_ckpt = None
    if ec is not None:
        # the shifts a rank sends, not those whose block stays
        ec_ckpt = ECCheckpoint(mesh, model.specs, ec, CountingComm(
            mesh, coords, ec.axis, count_stays=False))
        ec_ckpt.create(params)
        live += [ec_ckpt.parity, ec_ckpt._pages]
    step = make_rank_train_step(model, opt, ec=ec_ckpt)
    live = [t for t in live if t.device.type == "meta"]
    with ca.Count(live) as c, _counters_kept():
        step(params, opt_state, batch)
    return _rank_count(c, model)


def count_rank_forward(cfg, shape: ShapeSpec, mesh: Mesh, coords) -> dict:
    """The forward of the rank at ``coords`` on ``meta``: ``RankModel``
    on fresh tensors of its blocks' shapes, its moves counted by
    ``ranks.counting_comms``; a prefill cell's ``apply``, a decode cell's
    ``decode_step`` at the last slot of a seq_len cache.  FLOPs, bytes,
    peak (the rank's blocks, the batch and its cache block live),
    collective bytes and moves by kind, and the products every model
    position repeats (``RankModel.repeated``); ``OP_PATHS`` and ``DROPS``
    are left as they were.  Call inside ``dispatch.dry_run``."""
    local, live = _rank_blocks(cfg, mesh, coords)
    batch = make_inputs(cfg, shape, "meta")
    model = RankModel(cfg, local, counting_comms(mesh, coords))
    live += [t for t in batch.values() if t.device.type == "meta"]
    if shape.kind == "prefill":
        def step():
            return model.apply(batch)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 dtype=torch.bfloat16)
        live += [t for c in cache for t in c.values()]

        def step():
            return model.decode_step(cache, batch["tokens"],
                                     shape.seq_len - 1,
                                     batch.get("positions"))
    with ca.Count(live) as c, _counters_kept():
        step()
    return _rank_count(c, model)


def count_rank_cell(cfg, shape: ShapeSpec, mesh: Mesh,
                    optimizer: str = "adamw") -> dict:
    """``count_rank_forward`` (a train cell: ``count_rank_train``) at the
    config's depth (extrapolated as ``count_model_cell``) for every model
    position and every (pod, data) position with its own batch rows:
    ``positions`` (coords, the devices it stands for, its counts),
    ``busiest`` (the one with the most FLOPs) and
    ``flops_total``/``bytes_total`` over the mesh."""
    sizes = mesh.shape
    A, M, P = sizes["data"], sizes["model"], sizes.get("pod", 1)
    rows: dict = {}
    for p in range(P):
        for a in range(A):
            r0, r1 = batch_rows(shape.global_batch, A, a, P, p)
            rows.setdefault(r1 - r0, []).append((p, a) if P > 1 else (a,))
    positions = []
    for same in rows.values():
        for m in range(M):
            coords = same[0] + (m,)
            if shape.kind == "train":
                def count(c, coords=coords):
                    return count_rank_train(c, shape, mesh, coords,
                                            optimizer)
            else:
                def count(c, coords=coords):
                    return count_rank_forward(c, shape, mesh, coords)
            counts = count_model_cell(cfg, shape, mesh, count=count)
            positions.append(dict(coords=coords, devices=len(same),
                                  **counts))
    busiest = max(positions, key=lambda p: p["flops"])
    return {"positions": positions, "busiest": busiest,
            "flops_total": sum(p["devices"] * p["flops"] for p in positions),
            "bytes_total": sum(p["devices"] * p["bytes"] for p in positions)}


def _config(arch, remat, attn, kv):
    over = {"remat": remat}
    if attn is not None:
        over["attn_parallel"] = attn
    if kv is not None:
        over["kv_cache_dtype"] = kv
    return get_config(arch).scaled(**over)


def run_cell(arch: str, shape_name: str, mesh="single", *,
             optimizer="adamw8bit", remat="full", attn=None, kv=None,
             batch: int | None = None, seq: int | None = None) -> dict:
    """One cell's record: counts per device, the roofline terms, and the
    model FLOPs (6·N·D) against the counted ones.  ``mesh``: "single"
    (16 x 16), "multi" (2 x 16 x 16), "host" (1 x 1) or a ``Mesh``;
    ``batch``/``seq`` cut the shape."""
    mesh = _mesh(mesh)
    n_dev = mesh.size
    base = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
            "devices": n_dev}
    t0 = time.perf_counter()
    with dispatch.dry_run(), _counters_kept():
        if arch == "ecstore":
            op = shape_name if shape_name in ("update", "update_chain",
                                              "reconstruct") else "update"
            step, args, meta = build_ec_cell(mesh, op=op)
            with ca.Count([t for t, _ in args]) as c, torch.no_grad():
                step()
            # one device's counts; every position runs the same body
            counts = {"flops": c.flops * n_dev, "bytes": c.bytes * n_dev,
                      "peak": c.peak_bytes,
                      "flops_by_op": {k: v * n_dev
                                      for k, v in c.flops_by_op.items()},
                      "extrapolated_from": None}
            arg_bytes = ca.argument_bytes(args, mesh)
            arg_dev = sum(t.numel() for t, _ in args)
            coll = {k: 0 for k in COLLECTIVES}
            coll["collective-permute"] = c.permute_bytes
            counts_c = {"collective-permute": c.permutes}
            kind = "rank"
        else:
            cfg = _config(arch, remat, attn, kv)
            shape = cell_shape(shape_name, batch, seq)
            ok, why = shape_applicable(cfg, shape)
            if not ok:
                return dict(base, status="skipped", reason=why)
            refusal = rank_refusal(cfg, shape, mesh)
            kind = "rank" if refusal is None else "even split"
            if kind == "rank":
                cell = count_rank_cell(cfg, shape, mesh, optimizer)
                counts = dict(cell["busiest"])
                coll = {k: counts["collectives"].get(k, 0)
                        for k in COLLECTIVES}
                counts_c = counts["collective_counts"]
            else:
                counts = count_model_cell(cfg, shape, mesh, optimizer)
                coll = counts_c = None
            full = build_cell(cfg, shape, mesh, optimizer=optimizer)
            arg_bytes = ca.argument_bytes(full.args, mesh)
            arg_dev = full.device_bytes()
            meta = full.meta
    flops, nbytes = counts["flops"], counts["bytes"]
    res = dict(base, status="ok", build_s=round(time.perf_counter() - t0, 2),
               flops_total=flops, bytes_total=nbytes,
               flops_per_device=flops / n_dev,
               bytes_per_device=nbytes / n_dev,
               flops_by_op=counts["flops_by_op"],
               argument_bytes_per_device=arg_bytes,
               argument_bytes_one_card=arg_dev,
               peak_bytes_one_card=counts["peak"],
               peak_extrapolated=counts["extrapolated_from"] is not None,
               extrapolated_from=counts["extrapolated_from"], meta=meta,
               count=kind)
    if arch != "ecstore" and kind == "rank":
        res.update(count="rank", flops_total=cell["flops_total"],
                   bytes_total=cell["bytes_total"], flops_per_device=flops,
                   bytes_per_device=nbytes, peak_bytes_one_card=None,
                   peak_bytes_per_device=counts["peak"],
                   busiest_position=list(counts["coords"]),
                   repeated_products=counts["repeated"],
                   positions=[{k: p[k] for k in (
                       "coords", "devices", "flops", "bytes", "peak",
                       "collectives")} for p in cell["positions"]])
    res["t_compute"] = res["flops_per_device"] / PEAK_FLOPS
    res["t_memory"] = res["bytes_per_device"] / HBM_BW
    if coll is None:
        res.update(collective_bytes_per_device=None,
                   collective_wire_bytes_per_device=None, collectives=None,
                   collective_wire=None, collective_counts=None,
                   collective_note=NO_SPMD + (f"; {refusal}" if refusal
                                              else ""), t_collective=None)
    else:
        total = sum(coll.values())
        res.update(collective_bytes_per_device=total,
                   collective_wire_bytes_per_device=total,
                   collectives=coll, collective_wire=dict(coll),
                   collective_counts=counts_c,
                   collective_note=(RANK_NOTE if res["count"] == "rank" else
                                    "NVLink: every permute is one hop"),
                   t_collective=total / NVLINK_BW)
    terms = {k: res[f"t_{k}"] for k in ("compute", "memory", "collective")
             if res[f"t_{k}"] is not None}
    res["bottleneck"] = max(terms, key=terms.get)
    if arch != "ecstore":
        mf = model_flops(cfg, shape)
        res["model_flops_per_device"] = mf / n_dev
        res["useful_flops_ratio"] = (mf / res["flops_total"]
                                     if res["flops_total"] else 0.0)
    return res


def model_flops(cfg, shape: ShapeSpec) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); prefill 2·N·D; decode 2·N·B."""
    n_active = cfg.active_param_count()
    if shape.kind == "decode":
        return 2.0 * n_active * shape.global_batch
    tokens = shape.global_batch * shape.seq_len
    return (6.0 if shape.kind == "train" else 2.0) * n_active * tokens


def all_cells() -> list:
    cells = [(arch, s) for arch in ARCH_NAMES for s in SHAPES]
    cells += [("ecstore", "update"), ("ecstore", "update_chain"),
              ("ecstore", "reconstruct")]
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--optimizer", default="adamw8bit")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--attn", default=None, choices=["seq", "head", "auto"])
    ap.add_argument("--kv", default=None, choices=["bfloat16", "int8"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    archs = args.arch.split(",") if args.arch else None
    shapes = args.shape.split(",") if args.shape else None
    cells = [(a, s) for a, s in all_cells()
             if (not archs or a in archs) and (not shapes or s in shapes)]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    failed, t0 = 0, time.perf_counter()
    for arch, shape in cells:
        for mesh in meshes:
            tag = f"{arch}__{shape}__{mesh}" + (f"__{args.tag}"
                                                if args.tag else "")
            try:
                res = run_cell(arch, shape, mesh, optimizer=args.optimizer,
                               remat=args.remat, attn=args.attn, kv=args.kv)
            except Exception as e:  # noqa: BLE001 - recorded per cell
                failed += 1
                res = {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            extra = (res.get("reason") or res.get("error") or
                     f"bottleneck={res['bottleneck']} "
                     f"t=({res['t_compute']:.4g},{res['t_memory']:.4g},"
                     f"{res['t_collective'] or 0:.4g})s "
                     f"build {res['build_s']}s")
            print(f"[{tag}] {res['status']}: {extra}", flush=True)
    print(f"{len(cells) * len(meshes)} records in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
