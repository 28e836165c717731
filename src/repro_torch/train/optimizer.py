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
the rank's blocks, and ``init`` and ``apply`` take ``place``, a
``Blocks`` (the parameters' specs and the rank's communicators).  Each
optimizer's state is placed as the reference's ``_opt_specs`` places it
(``launch/dryrun.py``), and what a rank computes is the reference's
sharded program's:

* AdamW's moments are the rank's blocks of its parameters' moments and
  its count is replicated; ``place`` changes nothing;
* adamw8bit's ``{"q", "s"}`` are replicated: every rank holds the whole
  leaf's codes and scales, the same on every rank.  A rank dequantizes
  its own elements (their flat indices in the whole leaf, the stacked
  layer axis included: quantization blocks of 256 run over the flattened
  whole leaf and cross layer and block boundaries), steps them, takes
  each quantization block's partial absmax over them and combines them
  with a max all-reduce over the axes the leaf splits over; it then
  quantizes its elements and all-gathers the int8 codes, so ``q`` stays
  whole.  Only the statistics and the codes move, never a gradient;
* adafactor's ``vr``, ``vc`` and ``v`` are replicated: a rank's row and
  column sums of g² are summed over the axis that splits the other
  dimension and gathered whole, ``r`` comes from the whole ``vr``, and
  the update RMS is a sum of squares all-reduced over the axes the leaf
  splits over (each element counted once).  A vector leaf's ``v`` is
  stepped on the rank's block and gathered whole.

The moves are all-gathers and all-reduces of the rank's communicators, so
``collectives.recording`` and the dry run's ``count_rank_train`` count
them with the step's own.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..distributed.sharding import entry_axes, whole_leaf
from ..tree import Stacked, leaves, map_parts, materialize, tensors, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    apply: Callable
    name: str = ""


class Blocks(NamedTuple):
    """Where a rank's trees lie: ``specs``, the partition specs of the
    whole parameters (``sharding.param_specs``), and ``comms``, the
    rank's ``ranks.AxisComms`` (module notes)."""
    specs: dict
    comms: object

    def leaves(self) -> list:
        return leaves(self.specs)

    def whole_shape(self, shape, spec) -> tuple:
        """The whole leaf's shape of a block of ``shape`` laid out by
        ``spec``."""
        sizes = self.comms.mesh.shape
        return tuple(n * math.prod(sizes[a] for a in entry_axes(
            spec[i] if i < len(spec) else None)) for i, n in enumerate(shape))

    def offsets(self, shape, spec) -> list:
        """The block's first index in the whole leaf, dimension by
        dimension (``sharding.local_view``'s order: the first axis of an
        entry major)."""
        sizes, coords = self.comms.mesh.shape, self._coords()
        out = []
        for i, n in enumerate(shape):
            k = 0
            for a in entry_axes(spec[i] if i < len(spec) else None):
                k = k * sizes[a] + coords[a]
            out.append(k * n)
        return out

    def _coords(self) -> dict:
        return dict(zip(self.comms.mesh.axis_names, self.comms.coords))

    def split_axes(self, spec) -> list:
        """The mesh axes ``spec`` splits over."""
        return [a for e in spec for a in entry_axes(e)]

    def comm(self, axis: str):
        return {c.axis: c for c in self.comms.columns()}[axis]

    def reduce(self, x: torch.Tensor, axes, op: str = "sum"):
        """``x`` all-reduced over each of ``axes`` in turn."""
        for a in axes:
            x = self.comm(a).all_reduce(x, op=op)
        return x

    def whole(self, x: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor of which ``x`` is the rank's block by
        ``spec`` (``sharding.whole_leaf``)."""
        return whole_leaf(x, spec, self.comms)

    def flat_index(self, shape, spec, whole, r0: int, r1: int, dev):
        """The flat indices in the whole leaf (shape ``whole``) of rows
        [r0, r1) of the rank's block (shape ``shape``), int64 on ``dev``,
        shaped like those rows."""
        off = self.offsets(shape, spec)
        strides = [math.prod(whole[i + 1:]) for i in range(len(whole))]
        idx = (off[0] + torch.arange(r0, r1, device=dev)) * strides[0]
        idx = idx.reshape((-1,) + (1,) * (len(shape) - 1))
        for i in range(1, len(shape)):
            at = (off[i] + torch.arange(shape[i], device=dev)) * strides[i]
            idx = idx + at.reshape((-1,) + (1,) * (len(shape) - 1 - i))
        return idx


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

    def init(params, place: Blocks | None = None):
        # on a rank the moments are its blocks' (``place`` changes nothing)
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

    def apply(grads, state, params, grad_scale=None,
              place: Blocks | None = None):
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


def _row_chunks(shape):
    """[r0, r1) ranges of a block's first dimension, each at most about
    ``_CHUNK`` elements: the passes over a block hold its flat indices
    one range at a time."""
    per_row = max(1, math.prod(shape[1:]))
    step = max(1, _CHUNK // per_row)
    return [(r0, min(r0 + step, shape[0])) for r0 in range(0, shape[0], step)]


#: elements of a rank's block whose flat indices a pass holds at once
_CHUNK = 1 << 24


def _full_spec(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def adamw8bit(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
              warmup_steps: int = 100, schedule: str = "cosine",
              total_steps: int = 10000):
    sched = make_schedule(lr, warmup_steps, schedule, total_steps)

    def init(params, place: Blocks | None = None):
        """The quantized moments of each leaf; on a rank (``place``) of
        the whole leaf, replicated (module notes)."""
        def qz(p, spec=None):
            shape = p.shape if spec is None else place.whole_shape(p.shape,
                                                                   spec)
            q, s = _quantize(torch.zeros(shape, dtype=torch.float32,
                                         device=p.device))
            return {"q": q, "s": s}
        specs = () if place is None else (place.specs,)
        return {"m": tree_map(qz, params, *specs),
                "v": tree_map(qz, params, *specs),
                "count": torch.zeros((), dtype=torch.int32)}

    def _leaves(tree, n):
        # the {"q", "s"} subtree of each parameter leaf, in leaf order
        flat = leaves(tree)
        return [{"q": flat[2 * i], "s": flat[2 * i + 1]} for i in range(n)]

    def _moments(g, mq, vq, p, lr_t, bc1, bc2):
        """(update, m, v) of elements whose dequantized moments are
        given; the reference's arithmetic."""
        m = b1 * mq + (1 - b1) * g
        v = b2 * vq + (1 - b2) * g * g
        v = torch.clamp(v, min=0.0)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * p.float()
        return -lr_t * step, m, v

    def _rank_leaf(g, mq, vq, p, spec, place, lr_t, bc1, bc2, grad_scale):
        """One leaf's update on the rank's block (module notes): its
        elements found in the whole leaf's flat quantization blocks."""
        g, p = materialize(g), materialize(p)
        spec = _full_spec(spec, g.dim())
        whole = place.whole_shape(g.shape, spec)
        chunks = _row_chunks(g.shape)
        dev = g.device
        out, m, v = (torch.empty(g.shape, dtype=torch.float32, device=dev)
                     for _ in range(3))
        amax = torch.zeros((2, mq["s"].shape[0]), dtype=torch.float32,
                           device=dev)
        for r0, r1 in chunks:
            idx = place.flat_index(g.shape, spec, whole, r0, r1, dev)
            blk = idx // _QBLOCK
            deq = [st["q"].view(-1)[idx].float() * st["s"].view(-1)[blk]
                   for st in (mq, vq)]
            out[r0:r1], m[r0:r1], v[r0:r1] = _moments(
                _scaled(g[r0:r1], grad_scale), *deq, p[r0:r1], lr_t, bc1,
                bc2)
            for j, x in enumerate((m, v)):
                amax[j].scatter_reduce_(0, blk.reshape(-1),
                                        x[r0:r1].abs().reshape(-1), "amax")
        amax = place.reduce(amax, place.split_axes(spec), op="max")
        scale = torch.clamp(amax, min=1e-12) / 127.0
        n = math.prod(whole)
        for j, (st, x) in enumerate(((mq, m), (vq, v))):
            codes = torch.empty(g.shape, dtype=torch.int8, device=dev)
            for r0, r1 in chunks:
                blk = place.flat_index(g.shape, spec, whole, r0, r1,
                                       dev) // _QBLOCK
                codes[r0:r1] = torch.clamp(torch.round(
                    x[r0:r1] / scale[j][blk]), -127, 127).to(torch.int8)
            st["q"].view(-1)[:n].copy_(place.whole(codes, spec).reshape(-1))
            st["s"].copy_(scale[j][:, None])
        return out

    def _run(grads, state, params, grad_scale, place=None):
        c, lr_t, bc1, bc2 = _count_and_corrections(state, sched, b1, b2)
        gl, pl = leaves(grads), leaves(params)
        ml, vl = _leaves(state["m"], len(gl)), _leaves(state["v"], len(gl))
        if place is not None:
            out = [_rank_leaf(*a, place, lr_t, bc1, bc2, grad_scale)
                   for a in zip(gl, ml, vl, pl, place.leaves())]
            state["count"] = _new_count(state, c)
            return out, state

        def upd(g, mq, vq, p):
            g = _scaled(g, grad_scale)
            u, m, v = _moments(g, _dequantize(mq["q"], mq["s"], g.shape),
                               _dequantize(vq["q"], vq["s"], g.shape), p,
                               lr_t, bc1, bc2)
            for st, x in ((mq, m), (vq, v)):
                q, s = _quantize(x)
                st["q"].copy_(q)
                st["s"].copy_(s)
            return u

        out = _leafwise(upd, gl, ml, vl, pl)
        state["count"] = _new_count(state, c)
        return out, state

    def update(grads, state, params):
        out, state = _run(grads, state, params, None)
        return _unflatten_like(params, out), state

    def apply(grads, state, params, grad_scale=None,
              place: Blocks | None = None):
        out, state = _run(grads, state, params, grad_scale, place)
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

    def init(params, place: Blocks | None = None):
        """The factored second moments of each leaf; on a rank
        (``place``) of the whole leaf, replicated (module notes)."""
        def z(p, spec=None):
            shape = tuple(p.shape) if spec is None else \
                place.whole_shape(p.shape, spec)
            kw = dict(dtype=torch.float32, device=p.device)
            if len(shape) >= 2:
                return {"vr": torch.zeros(shape[:-1], **kw),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], **kw)}
            return {"v": torch.zeros(shape, **kw)}
        specs = () if place is None else (place.specs,)
        return {"f": tree_map(z, params, *specs),
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

    def _finish(step, p, lr_t, rms):
        step = step / torch.clamp(rms / clip_threshold, min=1.0)
        step = step + weight_decay * p.float()
        return -lr_t * step

    def _rank_leaf(g, f, p, spec, place, beta, lr_t, grad_scale):
        """One leaf's update on the rank's block (module notes)."""
        g = _scaled(materialize(g), grad_scale)
        spec = _full_spec(spec, g.dim())
        whole = place.whole_shape(g.shape, spec)
        off = place.offsets(g.shape, spec)
        g2 = g * g + eps
        if g.dim() >= 2:
            ea, eb = spec[-2], spec[-1]
            rows = place.whole(place.reduce(torch.sum(g2, dim=-1),
                                            entry_axes(eb)), spec[:-1])
            cols = place.whole(place.reduce(torch.sum(g2, dim=-2),
                                            entry_axes(ea)),
                               spec[:-2] + (eb,))
            vr = beta * f["vr"] + (1 - beta) * (rows / whole[-1])
            vc = beta * f["vc"] + (1 - beta) * (cols / whole[-2])
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=eps)
            # the rank's block of the whole factors: every dimension's
            # offset, a split leading one (an MoE expert leaf's) too
            at = [slice(o, o + n) for o, n in zip(off, g.shape)]
            r = r[tuple(at[:-1])]
            c = vc[tuple(at[:-2] + at[-1:])]
            step = g / (torch.sqrt(r)[..., None]
                        * torch.sqrt(c)[..., None, :] + 1e-12)
            f["vr"].copy_(vr)
            f["vc"].copy_(vc)
        else:
            v = beta * f["v"][off[0]:off[0] + g.shape[0]] + (1 - beta) * g2
            step = g / (torch.sqrt(v) + 1e-12)
            f["v"].copy_(place.whole(v, spec))
        sumsq = place.reduce(torch.sum(step * step), place.split_axes(spec))
        return _finish(step, materialize(p), lr_t,
                       torch.sqrt(sumsq / math.prod(whole)))

    def _run(grads, state, params, grad_scale, place=None):
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
            return _finish(step, p, lr_t, torch.sqrt(torch.mean(step * step)))

        gl, pl = leaves(grads), leaves(params)
        fl = _factors(state["f"], params)
        if place is not None:
            out = [_rank_leaf(*a, place, beta, lr_t, grad_scale)
                   for a in zip(gl, fl, pl, place.leaves())]
        else:
            out = _leafwise(upd, gl, fl, pl)
        state["count"] = _new_count(state, c)
        return out, state

    def update(grads, state, params):
        out, state = _run(grads, state, params, None)
        return _unflatten_like(params, out), state

    def apply(grads, state, params, grad_scale=None,
              place: Blocks | None = None):
        out, state = _run(grads, state, params, grad_scale, place)
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
