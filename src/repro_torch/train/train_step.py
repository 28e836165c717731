"""Training step: CE loss, grad clip, optimizer, optional EC parity fusion.

The port of the JAX package's ``train/train_step.py``.  The EC-fused step
is the paper's UPDATE path applied to training state: the optimizer's
parameter delta (old XOR new bytes) feeds the gamma-scaled delta-parity
update every step, keeping an erasure-coded in-memory copy of the model
continuously fresh.

``params`` is the model's own tree (``models.convert.param_tree``): the
forward reads the model, and the step updates its parameters in place
(the reference returns new ones).  So the EC hook cannot receive the old
parameters after the update, as the reference's ``ec_update_fn(old, new,
parity)`` does; it is an ``ECCheckpoint`` instead, whose ``stage`` packs
the old bytes into its page buffer before the optimizer runs and whose
``commit`` XORs in the new ones and updates the parity after it.

Across ranks (``make_rank_train_step``): one rank of a (data, model) or
(pod, data, model) mesh computes its part of the reference's sharded
step, ``jit(make_train_step(model, opt))`` under
``set_activation_mesh(mesh)`` with parameters by ``param_specs``, the
optimizer state by ``_opt_specs`` and the batch by ``batch_specs``.  The
loss is ``rank_cross_entropy`` over the rank's vocab block and batch
rows; the backward leaves each block's whole gradient over "model" and
"data" on the rank that holds it (``models/ranked.py``), the step then sums the
leaves that "data" does not split over the data column, and every leaf
over the pods (the pods replicate the parameters); the global norm
counts each block once (``rank_global_norm``), and the reference's clip
and optimizer run on the rank's blocks (``optimizer.Blocks``: AdamW's
moments are the rank's blocks, adamw8bit's and adafactor's state is
replicated whole and moves only statistics and codes).
"""
from __future__ import annotations

import torch

from ..distributed.sharding import entry_axes, writes_block
from ..models import Model, layers, moe
from ..models.convert import param_tree
from ..tree import (leaves, leaves_with_path, map_parts, materialize,
                    path_str, tensors, tree_map)
from .optimizer import Blocks, Optimizer, clip_scale, global_norm


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """logits (B,S,Vp) (padded vocab), labels (B,S) integers < logical
    vocab; the mean over tokens, in fp32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss.mean()


def rank_cross_entropy(logits, labels, comm, tokens: int,
                       z_loss: float = 1e-4):
    """``cross_entropy``'s terms of a rank's rows summed and divided by
    ``tokens`` (the global B·S times the rows' copies): ``logits`` is the
    rank's vocab block (rows, S, Vp/M) of model index ``comm.index``,
    ``labels`` its rows' labels.  The reference's arithmetic over the
    padded vocab: the row max and the sum of exponentials all-reduced
    over the model column ``comm``, the gold logit from the block that
    holds it, the z-loss on the log-sum-exp; in fp32."""
    from ..distributed import ranks
    lf = logits.float()
    Vl = lf.shape[-1]
    with torch.no_grad():
        mx = comm.all_reduce(lf.amax(dim=-1), op="max")
    se = ranks.all_reduce(comm, torch.exp(lf - mx[..., None]).sum(dim=-1))
    lse = mx + torch.log(se)
    ids = labels.long() - comm.index * Vl
    mine = (ids >= 0) & (ids < Vl)
    gold = torch.gather(lf, -1, ids.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = ranks.all_reduce(comm, torch.where(mine, gold, 0.0))
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss.sum() / tokens


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits = model(batch)
        loss = cross_entropy(logits, batch["labels"])
        return loss, {"loss": loss}
    return loss_fn


def _param_tensors(params) -> list:
    return [t for leaf in leaves(params) for t in tensors(leaf)]


def _grad(t: torch.Tensor) -> torch.Tensor:
    # a parameter the loss does not read (the token table of an
    # embeddings config) gets zeros, as jax.grad gives it
    if t.grad is None:
        t.grad = torch.zeros_like(t)
    return t.grad


def value_and_grad(loss_fn, params, batch):
    """((loss, aux), grads): the gradients of every parameter of
    ``params`` (made to require grad), as a tree like it."""
    for t in _param_tensors(params):
        t.requires_grad_(True)
        t.grad = None
    loss, aux = loss_fn(params, batch)
    loss.backward()
    grads = tree_map(lambda p: map_parts(_grad, p), params)
    return (loss.detach(), aux), grads


def make_train_step(model: Model, optimizer: Optimizer, *,
                    grad_clip: float = 1.0, ec=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), or with ``ec`` (an ``ECCheckpoint`` over ``params``) ->
    (params, opt_state, ec.parity, metrics).  The gradients are freed
    before the step returns."""
    loss_fn = make_loss_fn(model)

    def step(params, opt_state, batch):
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            gnorm = global_norm(grads)
            if ec is not None:
                ec.stage(params)
            opt_state = optimizer.apply(grads, opt_state, params,
                                        clip_scale(gnorm, grad_clip))
            del grads
            for t in _param_tensors(params):
                t.grad = None
            if ec is not None:
                ec.commit(params)
        metrics = {"loss": loss, "grad_norm": gnorm}
        if ec is None:
            return params, opt_state, metrics
        return params, opt_state, ec.parity, metrics

    return step


def make_rank_loss_fn(model):
    """``make_loss_fn`` of a ``ranked.RankModel``: (this rank's share of
    the mean loss, {"loss": it}); the shares of the (pod, data) positions
    sum to the reference's loss (a row held by c positions counts 1/c on
    each)."""
    def loss_fn(params, batch):
        labels = batch["labels"]
        B, S = labels.shape
        r0, r1 = model.rows(B)
        logits = model.forward(batch)
        loss = rank_cross_entropy(logits, labels[r0:r1], model.comms.model,
                                  B * S * model.copies(B))
        return loss, {"loss": loss}
    return loss_fn


def rank_global_norm(grads, specs, comms) -> torch.Tensor:
    """The global norm of the gradient whose blocks the ranks hold, each
    block counted once however it is replicated: a rank adds the squares
    of the blocks it writes (``sharding.writes_block``: coordinate 0 on
    every axis the leaf's spec does not split over), and the sum is
    all-reduced over every axis; fp32."""
    total = None
    for g, spec in zip(leaves(grads), leaves(specs)):
        if not writes_block(spec, comms.mesh, comms.coords):
            continue
        for t in tensors(g):
            sq = torch.sum(torch.square(t.float()))
            total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=leaves(grads)[0].device)
    for comm in comms.columns():
        total = comm.all_reduce(total)
    return torch.sqrt(total)


def _complete_grads(grads, specs, comms) -> None:
    """Sum in place, over the data column, the gradient of each leaf that
    "data" does not split (its blocks' uses on other rows), then every
    leaf's over the pods; in leaf order, the same on every rank."""
    mesh = comms.mesh
    for g, spec in zip(leaves(grads), leaves(specs)):
        by_data = "data" not in {a for e in spec for a in entry_axes(e)}
        for t in tensors(g):
            if by_data and mesh.shape["data"] > 1:
                t.copy_(comms.data.all_reduce(t))
            if comms.pod is not None and comms.pod.axis_size > 1:
                t.copy_(comms.pod.all_reduce(t))


def make_rank_train_step(model, optimizer: Optimizer, *,
                         grad_clip: float = 1.0, ec=None):
    """``make_train_step`` for a ``ranked.RankModel`` on its rank (module
    notes): train_step(params, opt_state, batch) with ``params`` the
    model's blocks (``model.params``), ``opt_state`` the optimizer's state
    of them (``optimizer.init(params, place=Blocks(model.specs,
    model.comms))``) and ``batch`` the whole batch; ``ec`` an
    ``ECCheckpoint(comm=...)`` over the rank's blocks.  The metrics are
    the reference's: the loss (summed over the data and pod columns) and
    the global gradient norm, the same on every rank.  On a 1 x 1 mesh it
    is ``make_train_step`` of the one-device model."""
    if model._one is not None:
        return make_train_step(model._one, optimizer, grad_clip=grad_clip,
                               ec=ec)
    loss_fn = make_rank_loss_fn(model)
    comms, specs = model.comms, model.specs
    place = Blocks(specs, comms)

    def step(params, opt_state, batch):
        # the backward on this thread: its collectives keep the order of
        # the other ranks' (and ``collectives.recording`` sees them)
        with torch.autograd.set_multithreading_enabled(False):
            (loss, _), grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            _complete_grads(grads, specs, comms)
            gnorm = rank_global_norm(grads, specs, comms)
            if ec is not None:
                ec.stage(params)
            opt_state = optimizer.apply(grads, opt_state, params,
                                        clip_scale(gnorm, grad_clip),
                                        place=place)
            del grads
            for t in _param_tensors(params):
                t.grad = None
            if ec is not None:
                ec.commit(params)
            for comm in comms.columns():
                if comm.axis != "model":
                    loss = comm.all_reduce(loss)
        metrics = {"loss": loss, "grad_norm": gnorm}
        if ec is None:
            return params, opt_state, metrics
        return params, opt_state, ec.parity, metrics

    return step


def recorded_step(model: Model, optimizer: Optimizer, batch) -> dict:
    """One step of ``make_train_step`` from ``model``'s parameters, with
    what a check holds against another run of it: ``loss``,
    ``grad_norm``, ``grads`` (as the optimizer gets them) and ``params``
    (after the step), both float32 CPU copies by tree path (``"blocks/0/
    attn/wq"``), ``op_paths`` (``layers.OP_PATHS``), ``drops``
    (``moe.dropped_assignments()``) and ``routes`` (each MoE call's top-K
    experts).  The counters are reset first."""
    seen = {}

    def apply(grads, state, p, scale):
        seen["grads"] = _host_copy(grads)
        return optimizer.apply(grads, state, p, scale)
    layers.reset_op_paths()
    moe.reset_drops()
    params = param_tree(model)
    step = make_train_step(model, Optimizer(optimizer.init, optimizer.update,
                                            apply))
    with moe.record_routes() as routes:
        _, _, m = step(params, optimizer.init(params), batch)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                grads=seen["grads"], params=_host_copy(params),
                op_paths=dict(layers.OP_PATHS),
                drops=moe.dropped_assignments(), routes=routes)


def _host_copy(tree) -> dict:
    return {path_str(k): materialize(t).detach().to("cpu", torch.float32,
                                                     copy=True)
            for k, t in leaves_with_path(tree)}


def eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def step(params, batch):
        loss, _ = loss_fn(params, batch)
        return loss

    return step
