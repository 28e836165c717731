"""Optimizers in torch: AdamW, AdamW-8bit (quantized state), Adafactor.

The port of the JAX package's ``train/optimizer.py``, with its optax-like
API: ``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; ``apply_updates(params, updates)``.  The arithmetic
and its order are the reference's; the schedule, the step count and the
bias corrections are computed on the host in float32.

Trees are ``repro_torch.tree`` trees in the reference's layout (dicts,
lists, ``Stacked`` leaves).  The port updates in place where that saves
memory: the moments are updated in place (``update`` returns the same
state), ``apply_updates`` writes into the parameters, and ``opt.apply
(grads, state, params, grad_scale)`` does update and apply one tensor at
a time, so no tree of updates (17 GB at starcoder2-3b's width) is ever
held.  AdamW is elementwise and runs part by part on ``Stacked`` leaves;
AdamW-8bit (quantization blocks span the stacked leaf) and Adafactor
(row/column statistics and an RMS over the stacked leaf) take a stacked
copy of each such leaf.

On a rank of a mesh (``train_step.make_rank_train_step``) the trees are
the rank's blocks: AdamW's moments are then the rank's blocks of its
parameters' moments and its count is replicated, as the reference's
``_opt_specs`` places them.  ``adamw8bit`` and ``adafactor`` refuse a
mesh larger than 1 x 1 (``check_ranks``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..tree import Stacked, leaves, map_parts, materialize, tensors, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    apply: Callable
    name: str = ""


#: ROADMAP.md Queue 1 item that ports the other optimizers across ranks
RANKS_ITEM = (13, "adamw8bit and adafactor across ranks")


def check_ranks(opt: Optimizer, mesh) -> None:
    """Raise unless ``opt``'s state splits into a rank's blocks on
    ``mesh``: on a mesh larger than 1 x 1 only AdamW's does.  adamw8bit
    quantizes blocks of 256 over each whole flattened leaf and keeps its
    ``q``/``s`` replicated, which a rank's 2-D block does not align with;
    adafactor's row and column statistics and its update RMS span whole
    leaves."""
    if mesh.size == 1 or opt.name == "adamw":
        return
    n, what = RANKS_ITEM
    raise NotImplementedError(
        f"the {opt.name or 'given'} optimizer across ranks is not ported "
        f"yet; ROADMAP.md Queue 1 item {n} ({what}) ports it")


def _apply_one(p: torch.Tensor, u: torch.Tensor) -> None:
    p.copy_((p.float() + u).to(p.dtype))


def _set_leaf(p, u) -> None:
    """Apply one leaf's update (a tensor, or stacked over its parts)."""
    if isinstance(p, Stacked):
        for r, part in enumerate(p.parts):
            _apply_one(part, u.parts[r] if isinstance(u, Stacked) else u[r])
    else:
        _apply_one(p, u)


def apply_updates(params, updates):
    """params <- (params in fp32 + updates) cast back, in place."""
    for p, u in zip(leaves(params), leaves(updates)):
        _set_leaf(p, u)
    return params


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in leaves(tree):
        for t in tensors(leaf):
            total = total + torch.sum(torch.square(t.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_scale(norm: torch.Tensor, max_norm) -> torch.Tensor:
    """min(1, max_norm / norm): the factor ``clip_by_global_norm``
    applies, for an optimizer that scales each gradient as it reads it."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads * min(1, max_norm / norm), norm); bf16 grads come back fp32,
    as the reference's product with an fp32 scale promotes them."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: map_parts(lambda t: t.float() * scale, g),
                    grads), norm


def _scaled(g: torch.Tensor, grad_scale) -> torch.Tensor:
    g = g.float()
    return g if grad_scale is None else g * grad_scale


def _f32(x) -> float:
    return float(np.float32(x))


def _count_and_corrections(state, sched, b1, b2):
    c = int(state["count"]) + 1
    cf = np.float32(c)
    bc1 = _f32(np.float32(1) - np.float32(b1) ** cf)
    bc2 = _f32(np.float32(1) - np.float32(b2) ** cf)
    return c, _f32(sched(c)), bc1, bc2


def _new_count(state, c: int) -> torch.Tensor:
    count = state["count"]
    count.fill_(c)
    return count


# ---------------------------------------------------------------------------
# AdamW (fp32 moments)
# ---------------------------------------------------------------------------

def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
          warmup_steps: int = 100, schedule: str = "cosine",
          total_steps: int = 10000):
    sched = make_schedule(lr, warmup_steps, schedule, total_steps)

    def init(params):
        def z(p):
            return map_parts(lambda t: torch.zeros(t.shape,
                                                   dtype=torch.float32,
                                                   device=t.device), p)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "count": torch.zeros((), dtype=torch.int32)}

    def _step(g, m, v, p, lr_t, bc1, bc2, grad_scale):
        g = _scaled(g, grad_scale)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * p.float()
        return -lr_t * step

    def update(grads, state, params):
        c, lr_t, bc1, bc2 = _count_and_corrections(state, sched, b1, b2)
        updates = tree_map(
            lambda g, m, v, p: map_parts(
                lambda *a: _step(*a, lr_t, bc1, bc2, None), g, m, v, p),
            grads, state["m"], state["v"], params)
        state["count"] = _new_count(state, c)
        return updates, state

    def apply(grads, state, params, grad_scale=None):
        c, lr_t, bc1, bc2 = _count_and_corrections(state, sched, b1, b2)
        for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                              leaves(state["v"]), leaves(params)):
            for gt, mt, vt, pt in zip(tensors(g), tensors(m), tensors(v),
                                      tensors(p)):
                _apply_one(pt, _step(gt, mt, vt, pt, lr_t, bc1, bc2,
                                     grad_scale))
        state["count"] = _new_count(state, c)
        return state

    return Optimizer(init, update, apply, "adamw")


# ---------------------------------------------------------------------------
# AdamW-8bit: int8 blockwise-quantized moments
# ---------------------------------------------------------------------------

_QBLOCK = 256


def _quantize(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=1, keepdim=True),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q, scale, shape):
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def _leafwise(fn, *trees):
    """One result per leaf of ``trees[0]`` from whole (stacked) leaves."""
    return [fn(*(materialize(x) if i in (0, len(trees) - 1) else x
                 for i, x in enumerate(xs)))
            for xs in zip(*trees)]


def adamw8bit(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
              warmup_steps: int = 100, schedule: str = "cosine",
              total_steps: int = 10000):
    sched = make_schedule(lr, warmup_steps, schedule, total_steps)

    def init(params):
        def qz(p):
            q, s = _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device))
            return {"q": q, "s": s}
        return {"m": tree_map(qz, params), "v": tree_map(qz, params),
                "count": torch.zeros((), dtype=torch.int32)}

    def _leaves(tree, n):
        # the {"q", "s"} subtree of each parameter leaf, in leaf order
        flat = leaves(tree)
        return [{"q": flat[2 * i], "s": flat[2 * i + 1]} for i in range(n)]

    def _run(grads, state, params, grad_scale):
        c, lr_t, bc1, bc2 = _count_and_corrections(state, sched, b1, b2)
        gl, pl = leaves(grads), leaves(params)

        def upd(g, mq, vq, p):
            g = _scaled(g, grad_scale)
            m = b1 * _dequantize(mq["q"], mq["s"], g.shape) + (1 - b1) * g
            v = b2 * _dequantize(vq["q"], vq["s"], g.shape) \
                + (1 - b2) * g * g
            v = torch.clamp(v, min=0.0)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            step = step + weight_decay * p.float()
            for st, x in ((mq, m), (vq, v)):
                q, s = _quantize(x)
                st["q"].copy_(q)
                st["s"].copy_(s)
            return -lr_t * step

        out = _leafwise(upd, gl, _leaves(state["m"], len(gl)),
                        _leaves(state["v"], len(gl)), pl)
        state["count"] = _new_count(state, c)
        return out, state

    def update(grads, state, params):
        out, state = _run(grads, state, params, None)
        return _unflatten_like(params, out), state

    def apply(grads, state, params, grad_scale=None):
        out, state = _run(grads, state, params, grad_scale)
        for p, u in zip(leaves(params), out):
            _set_leaf(p, u)
        return state

    return Optimizer(init, update, apply, "adamw8bit")


def _unflatten_like(tree, flat: list):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment)
# ---------------------------------------------------------------------------

def adafactor(lr=1e-3, decay=0.8, eps=1e-30, weight_decay=0.0,
              warmup_steps: int = 100, schedule: str = "cosine",
              total_steps: int = 10000, clip_threshold: float = 1.0):
    sched = make_schedule(lr, warmup_steps, schedule, total_steps)

    def init(params):
        def z(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if len(p.shape) >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"v": torch.zeros(p.shape, **kw)}
        return {"f": tree_map(z, params),
                "count": torch.zeros((), dtype=torch.int32)}

    def _factors(f_tree, params):
        # each leaf's {"vc", "vr"} or {"v"} subtree, in leaf order
        out = []
        flat = leaves(f_tree)
        i = 0
        for p in leaves(params):
            if len(p.shape) >= 2:
                out.append({"vr": flat[i + 1], "vc": flat[i]})
                i += 2
            else:
                out.append({"v": flat[i]})
                i += 1
        return out

    def _run(grads, state, params, grad_scale):
        c = int(state["count"]) + 1
        lr_t = _f32(sched(c))
        beta = _f32(np.float32(1.0) - np.float32(c) ** np.float32(-decay))

        def upd(g, f, p):
            g = _scaled(g, grad_scale)
            g2 = g * g + eps
            if g.dim() >= 2:
                vr = beta * f["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * f["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                     min=eps)
                step = g / (torch.sqrt(r)[..., None]
                            * torch.sqrt(vc)[..., None, :] + 1e-12)
                f["vr"].copy_(vr)
                f["vc"].copy_(vc)
            else:
                v = beta * f["v"] + (1 - beta) * g2
                step = g / (torch.sqrt(v) + 1e-12)
                f["v"].copy_(v)
            rms = torch.sqrt(torch.mean(step * step))
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            step = step + weight_decay * p.float()
            return -lr_t * step

        gl, pl = leaves(grads), leaves(params)
        out = _leafwise(upd, gl, _factors(state["f"], params), pl)
        state["count"] = _new_count(state, c)
        return out, state

    def update(grads, state, params):
        out, state = _run(grads, state, params, None)
        return _unflatten_like(params, out), state

    def apply(grads, state, params, grad_scale=None):
        out, state = _run(grads, state, params, grad_scale)
        for p, u in zip(leaves(params), out):
            _set_leaf(p, u)
        return state

    return Optimizer(init, update, apply, "adafactor")


def make_schedule(peak_lr, warmup_steps, kind, total_steps):
    """step (an int) -> the learning rate, in float32 as the reference."""
    f = np.float32

    def sched(step: int):
        s = f(step)
        warm = s / f(max(warmup_steps, 1))
        if kind == "cosine":
            prog = np.clip((s - f(warmup_steps)) /
                           f(max(total_steps - warmup_steps, 1)),
                           f(0), f(1))
            decay = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
        elif kind == "linear":
            decay = np.clip(f(1) - (s - f(warmup_steps)) /
                            f(max(total_steps - warmup_steps, 1)),
                            f(0), f(1))
        else:
            decay = f(1.0)
        return f(peak_lr) * np.minimum(warm, f(1.0)) * decay
    return sched


OPTIMIZERS = {"adamw": adamw, "adamw8bit": adamw8bit, "adafactor": adafactor}


def make_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)
