"""Rank bodies for the tests of ``distributed/ranks.py``.

``repro_torch.distributed.ranks.launch`` runs these in spawned processes,
one per mesh position, so they live in a module the ranks can import.
It imports no JAX: the ranks read the reference's arrays from its
``.npz`` and write their own outputs to one ``.npz`` per rank, which the
tests compare.
"""
import time

import numpy as np
import torch

from repro_torch.distributed import collectives, ecstore, sharding
from repro_torch.distributed.collectives import recording
from repro_torch.distributed.ranks import rank_comms
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.ranked import RankModel, init_blocks
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.checkpoint import ECCheckpoint
from repro_torch.tree import Stacked, leaves, tree_map


class Reversed:
    """A faulted ring: every shift goes the other way."""

    def __init__(self, comm):
        self.comm = comm
        self.axis_size = comm.axis_size
        self.index = comm.index
        self.op_paths = {}

    def shift(self, x, s):
        return self.comm.shift(x, -s)


def _counted(sent: dict, op: str, fn, *args):
    """``fn(*args)`` with the bytes this rank sends added to ``sent[op]``."""
    got = []
    with recording(lambda n, kind: got.append(n)):
        out = fn(*args)
    sent[op] = sent.get(op, 0) + sum(got)
    return out


def _local(tree, specs, mesh, coords, clone=False):
    def block(leaf, spec):
        b = sharding.local_block(leaf, spec, mesh, coords)
        if not clone:
            return b
        if isinstance(b, Stacked):
            return Stacked(p.clone() for p in b.parts)
        return b.clone()
    return tree_map(block, tree, specs)


def _checkpoint(comm, out: dict, sent: dict, cfg, specs, old, new,
                rebuild_at) -> None:
    """``ECCheckpoint`` on this rank's blocks of ``old``/``new``: create,
    ``update``, then stage, an in-place change of a private copy of the
    old blocks into the new ones, commit; rebuilds of the new state."""
    mesh, coords = comm.mesh, comm.coords
    old_local = _local(old, specs, mesh, coords)
    new_local = _local(new, specs, mesh, coords)
    live = _local(old, specs, mesh, coords, clone=True)
    ec = ECCheckpoint(mesh, specs, cfg, comm)
    out["ckpt/pages"] = ec.store.local_pages(old_local).numpy()
    out["ckpt/create"] = _counted(sent, "ckpt_create", ec.create,
                                  live).clone().numpy()
    out["ckpt/update"] = ec.store.delta_update(old_local, new_local,
                                               ec.parity).numpy()
    ec.stage(live)
    tree_map(lambda dst, src: dst.copy_(src), live, new_local)
    out["ckpt/commit"] = _counted(sent, "ckpt_commit", ec.commit,
                                  live).numpy()
    out["ckpt/live"] = ec.store.local_pages(live).numpy()
    for f in rebuild_at:
        out[f"ckpt/reconstruct{f}"] = _counted(
            sent, "ckpt_reconstruct", ec.reconstruct, live, f).numpy()


def _protected_cache(comm, ref, out: dict, cfg, k, m, page) -> None:
    """``ServeEngine.protect_cache`` on a ``RankModel`` of ``cfg`` (its
    blocks drawn from seed 0; the cache's values are the reference's):
    the engine's cache block set to this rank's block of the reference's
    prefill cache (``cache/leaf{i}``, placed by ``cache_specs`` of the
    engine's ``cache_shapes``), then its pages, parity and the rebuilds
    of data positions 0 and 2."""
    mesh, coords = comm.mesh, comm.coords
    model = RankModel(cfg, init_blocks(cfg, mesh, coords,
                                       torch.Generator().manual_seed(0)),
                      rank_comms(comm))
    eng = ServeEngine(model, max_len=16, batch_size=4, device="cpu")
    specs = sharding.cache_specs(cfg, eng.cache_shapes(), mesh)
    for i, (leaf, spec) in enumerate(zip(leaves(eng.cache_tree()),
                                         leaves(specs))):
        bits = torch.from_numpy(ref[f"cache/leaf{i}"].view(np.int16))
        leaf.copy_(sharding.local_block(bits.view(torch.bfloat16), spec,
                                        mesh, coords))
    eng.protect_cache(mesh, specs, ecstore.ECConfig(k=k, m=m, page_size=page))
    out["cache/pages"] = eng.ec_store.local_pages(eng.cache_tree()).numpy()
    out["cache/parity"] = eng.ec_parity.numpy()
    for fail in (0, 2):
        out[f"cache/recover{fail}"] = eng.recover_cache_pages(fail).numpy()


def mesh_body(comm, ref_path, out_path, name, k, m, page, pairs,
              rebuild_at, params, specs, cache_cfg=None):
    """Every EC operation and collective of one position: on the
    reference's random pages (``name``'s arrays in ``ref_path``; none for
    a mesh the reference's tests do not have), then ``ECCheckpoint`` on
    the parameter trees ``params`` (old, new) under ``specs``; with
    ``cache_cfg``, the reference's serving cache protected on a
    ``RankModel`` of that config (``_protected_cache``).  Returns the
    bytes sent per operation, the kernel launches and ``op_paths``."""
    cfg = ecstore.ECConfig(k=k, m=m, page_size=page)
    at = comm.coords
    out, sent = {}, {}
    reset_launch_counts()
    t0 = time.perf_counter()
    with np.load(ref_path) as f:
        ref = {key: f[key] for key in f.files
               if key.startswith((f"{name}/", "coll/", "cache/"))}

    def mine(key):
        return torch.from_numpy(np.ascontiguousarray(ref[key][at]))

    if f"{name}/state" in ref:
        state, xor, enc = (mine(f"{name}/{x}")
                           for x in ("state", "xor", "encode"))
        out["encode"] = _counted(sent, "encode", ecstore.rank_encode_parity,
                                 state, cfg, comm).numpy()
        out["update"] = _counted(sent, "update",
                                 ecstore.rank_parity_delta_update, xor, enc,
                                 cfg, comm).numpy()
        out["update_chain"] = _counted(
            sent, "update_chain", ecstore.rank_parity_delta_update_chain,
            xor, enc, cfg, comm).numpy()
        for fail in rebuild_at:
            out[f"reconstruct{fail}"] = _counted(
                sent, "reconstruct", ecstore.rank_reconstruct_failed,
                mine(f"{name}/holed{fail}"), enc, fail, cfg, comm).numpy()
        if m >= 2:
            for f1, f2 in pairs:
                out[f"pair{f1}_{f2}"] = _counted(
                    sent, "reconstruct_pair",
                    ecstore.rank_reconstruct_failed_pair,
                    mine(f"{name}/pair_in{f1}_{f2}"),
                    mine(f"{name}/pair_par{f1}_{f2}"), f1, f2, cfg,
                    comm).numpy()
        out["faulted_encode"] = ecstore.rank_encode_parity(
            state, cfg, Reversed(comm)).numpy()
    if "coll/x" in ref and comm.axis_size == ref["coll/x"].shape[0]:
        x, fl = mine("coll/x"), mine("coll/f")
        for shift in (1, 5):
            out[f"ring_shift{shift}"] = collectives.rank_ring_shift(
                x, comm, shift).numpy()
        out["ring_xor_reduce"] = collectives.rank_ring_xor_reduce(
            x, comm).numpy()
        out["compressed_psum"] = collectives.rank_compressed_psum(
            fl, comm, block=64).numpy()
    old, new = params
    _checkpoint(comm, out, sent, cfg, specs, old, new, rebuild_at)
    if cache_cfg is not None:
        _protected_cache(comm, ref, out, cache_cfg, k, m, page)
    np.savez(out_path, **out)
    return {"sent": sent, "launches": launch_counts(),
            "op_paths": dict(comm.op_paths),
            "seconds": time.perf_counter() - t0}


def cuda_body(comm, pages, xor, grads, k, m, page):
    """Encode, update and a rebuild of data index 0 on the card (two
    ranks sharing ``cuda:0``), and the compressed psum of ``grads``;
    returns the outputs on the host, the bytes sent, the kernel launches
    and ``op_paths``."""
    cfg = ecstore.ECConfig(k=k, m=m, page_size=page)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mine = pages[comm.coords].to(dev)
    delta = xor[comm.coords].to(dev)
    sent = {}
    reset_launch_counts()
    enc = _counted(sent, "encode", ecstore.rank_encode_parity, mine, cfg,
                   comm)
    upd = _counted(sent, "update", ecstore.rank_parity_delta_update, delta,
                   enc, cfg, comm)
    rec = _counted(sent, "reconstruct", ecstore.rank_reconstruct_failed,
                   mine, enc, 0, cfg, comm)
    psum = collectives.rank_compressed_psum(grads[comm.coords].to(dev),
                                            comm, block=64)
    torch.cuda.synchronize()
    return {"encode": enc.cpu().numpy(), "update": upd.cpu().numpy(),
            "reconstruct": rec.cpu().numpy(), "psum": psum.cpu().numpy(),
            "sent": sent,
            "launches": launch_counts(), "op_paths": dict(comm.op_paths)}


def failing_body(comm):
    """Rank 1 raises."""
    if comm.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return comm.rank


def hanging_body(comm):
    """Rank 1 never returns."""
    if comm.rank == 1:
        time.sleep(3600)
    return comm.rank
