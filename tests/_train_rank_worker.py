"""Rank bodies for ``tests/test_torch_train_ranks.py``.

``repro_torch.distributed.ranks.launch`` runs these in spawned processes,
one per mesh position, so they live in a module the ranks can import.  It
imports no JAX.  A rank answers with numpy arrays (pickled by value), not
tensors: it exits right after answering.
"""
import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import recording
from repro_torch.distributed.ecstore import ECConfig
from repro_torch.distributed.ranks import RankComm, rank_comms
from repro_torch.kernels import dispatch
from repro_torch.launch import dryrun
from repro_torch.launch.train import state_specs_of, train_on_rank
from repro_torch.models import layers
from repro_torch.models.ranked import RankModel
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import Blocks, make_optimizer
from repro_torch.tree import leaves_with_path, materialize, path_str, tree_map

#: the EC copy the jobs keep, as ``launch.train --ec`` at its defaults
EC = dict(k=2, m=1)
#: AdamW as ``tests/test_torch_train_archs.py`` runs it: both steps move
#: the parameters (a schedule of two steps would end at a rate of 0)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _np(tree) -> dict:
    """Float32 numpy copies of a tree's leaves, by path."""
    return {path_str(k): materialize(t).detach().float().numpy().copy()
            for k, t in leaves_with_path(tree)}


def _own(blocks):
    """The rank's own copies of its blocks (they arrive in shared memory,
    and training updates them in place)."""
    return tree_map(lambda x: type(x)([p.clone() for p in x.parts])
                    if hasattr(x, "parts") else x.clone(), blocks)


def _state_specs(opt, model) -> dict:
    return {"p": model.specs, "o": state_specs_of(opt, model)}


def _job(comm, cfg, blocks, batch, seq, steps, save_to=None,
         optimizer="adamw"):
    """``train_on_rank`` for ``steps`` steps of ``optimizer`` with the EC
    copy: per step the loss, the norm, the parameter blocks, the
    optimizer's state (AdamW's moment blocks; adamw8bit's and adafactor's
    whole replicated state) and whether the parity equals a fresh encode;
    step 1's gradient blocks; the bytes step 2 sent by kind beside
    ``dryrun.count_rank_train``'s count at the rank's coordinates; with
    ``save_to``, a disk checkpoint written from the ranks after the last
    step."""
    opt = make_optimizer(optimizer, **OPT)
    seen = {}

    def apply(grads, state, params, scale, place=None):
        if "grads" not in seen:
            seen["grads"] = _np(grads)
        return opt.apply(grads, state, params, scale, place=place)

    sent: dict = {}
    snaps, steps_out = [], []

    def observe(step, st):
        snaps.append(dict(sent))
        with recording(lambda n, kind: None):     # not the step's bytes
            fresh = st["ec"].store.encode(st["params"])
        steps_out.append(dict(
            loss=float(st["metrics"]["loss"]),
            grad_norm=float(st["metrics"]["grad_norm"]),
            params=_np(st["params"]),
            state={part: _np(tree) for part, tree in st["opt_state"].items()
                   if part != "count"},
            stale=int((fresh != st["ec"].parity).sum())))
        seen["model"] = st["model"]
        seen["state"] = {"p": st["params"], "o": st["opt_state"]}
        seen["opt"] = opt

    layers.reset_op_paths()
    with recording(lambda n, kind: sent.__setitem__(kind,
                                                    sent.get(kind, 0) + n)):
        train_on_rank(comm, cfg, _own(blocks), steps=steps, batch=batch,
                      seq=seq, optimizer=opt._replace(apply=apply),
                      ec=True, ec_k=EC["k"], ec_m=EC["m"], observe=observe,
                      log=lambda *a: None)
    model = seen["model"]
    step2 = {k: v - snaps[0].get(k, 0) for k, v in snaps[1].items()}
    with dispatch.dry_run():
        want = dryrun.count_rank_train(
            cfg, dryrun.ShapeSpec("x", "train", seq, batch), model.mesh,
            model.comms.coords, optimizer=optimizer,
            ec=ECConfig(k=EC["k"], m=EC["m"], page_size=256))
    if save_to is not None:
        ckpt.save_checkpoint(save_to, steps, seen["state"],
                             specs=_state_specs(opt, model),
                             comms=model.comms)
    return dict(coords=model.comms.coords, steps=steps_out,
                grads=seen["grads"], sent=step2, counted=want["collectives"],
                op_paths=dict(model.op_paths), routes=dict(layers.OP_PATHS))


def _optimizer(name: str) -> str:
    """The optimizer a job's name asks for ("arch/mode[/opt][/pod]")."""
    parts = name.split("/")[2:]
    return next((p for p in parts if p != "pod"), "adamw")


def train_body(comm, jobs, pod_mesh, pod_jobs, batch, seq, steps, saves,
               restore):
    """Each (name, cfg, blocks) of ``jobs`` on this rank of ``comm``'s
    mesh, then each of ``pod_jobs`` (blocks at this rank's coordinates
    on ``pod_mesh``) on the same ranks as ``pod_mesh``'s positions
    (``_job``, with the optimizer the name gives); ``saves`` maps a
    job's name to a directory it writes a disk checkpoint to.
    ``restore``: (directory, step, blocks) of a checkpoint the reference
    wrote, which the rank reads into its blocks of the first job's model
    (``restore_checkpoint`` by ``local_block``)."""
    torch.set_num_threads(1)
    comms = rank_comms(comm)
    out = {}
    for name, cfg, blocks in jobs:
        out[name] = _job(comms, cfg, blocks, batch, seq, steps,
                         saves.get(name), _optimizer(name))
    pod_comms = rank_comms(RankComm(pod_mesh))
    for name, cfg, blocks in pod_jobs:
        out[name] = _job(pod_comms, cfg, blocks, batch, seq, steps,
                         optimizer=_optimizer(name))
    d, step, blocks = restore
    _, cfg, _ = jobs[0]
    model = RankModel(cfg, _own(blocks), comms)
    opt = make_optimizer("adamw")
    state = {"p": model.params, "o": opt.init(model.params)}
    ckpt.restore_checkpoint(d, step, state, specs=_state_specs(opt, model),
                            mesh=comm.mesh, coords=comm.coords)
    out["restored"] = {"p": _np(state["p"]), "m": _np(state["o"]["m"]),
                       "v": _np(state["o"]["v"]),
                       "count": int(state["o"]["count"])}
    return out


def optimizer_body(comm, params, grads, specs, names, kw):
    """Each optimizer of ``names`` (``make_optimizer(name, **kw)``) on this
    rank's blocks (``sharding.local_block`` by ``specs``) of the whole
    trees ``params`` and of each gradient tree of ``grads``, one
    ``apply`` a tree, placed by ``optimizer.Blocks``: the rank's
    parameter blocks and its state after each step."""
    torch.set_num_threads(1)
    comms = rank_comms(comm)
    mesh, coords = comms.mesh, comms.coords

    def block(tree):
        return _own(tree_map(lambda leaf, spec: sharding.local_block(
            leaf, spec, mesh, coords), tree, specs))
    out = {"coords": coords}
    for name in names:
        opt = make_optimizer(name, **kw)
        place = Blocks(specs, comms)
        local = block(params)
        state = opt.init(local, place=place)
        steps = []
        for g in grads:
            opt.apply(block(g), state, local, place=place)
            steps.append({"params": _np(local), "state": _np(state)})
        out[name] = steps
    return out
