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
"""
from __future__ import annotations

import torch

from ..models import Model, layers, moe
from ..models.convert import param_tree
from ..tree import (leaves, leaves_with_path, map_parts, materialize,
                    path_str, tensors, tree_map)
from .optimizer import Optimizer, clip_scale, global_norm


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
