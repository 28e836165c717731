"""Sharding rules: param-path -> PartitionSpec over ("pod","data","model"),
and the local view of a leaf at each mesh position.

The rules are the reference's (``src/repro/distributed/sharding.py``),
framework-free logic on path strings and shapes, copied with
``jax.sharding.PartitionSpec`` replaced by ``P``, a plain tuple of the same
entries.  Strategy (reference DESIGN.md §6):
* batch -> ("pod","data"); FSDP param+optimizer sharding -> "data";
  tensor parallel -> "model".
* Attention: Q heads -> "model"; KV heads replicated (small); decode KV
  caches shard the *sequence* dim on "model" instead.
* MoE: experts -> "model" (EP).
* Mamba/RG-LRU: d_inner / recurrent width -> "model".
* vocab -> "model" for embedding + logits.

Rules match on path substrings; first hit wins.  Everything unmatched is
replicated (norms, biases, small vectors).

What ``shard_map`` gave the reference is ``local_view``: the slice of a
leaf a (pod, data, model) position holds - along every dimension its spec
maps to mesh axes, that position's block; a replicated leaf whole at
every position.  For the store stacked on one card (``launch/mesh.py``)
the views of every position come back as one strided view with the mesh
axes as its leading dimensions; ``local_block`` is one position's, what a
rank of ``distributed/ranks.py`` packs its own state from.
"""
from __future__ import annotations

import math
import re

import torch

from ..models.config import ModelConfig
from ..tree import Stacked, path_str, tree_map_with_path


class P(tuple):
    """A partition spec: one entry per leading dimension of a leaf, each
    None (not split), a mesh axis name or a tuple of them (split over
    their product, the first axis major).  A tuple of one name becomes
    the name, as ``jax.sharding.PartitionSpec`` stores it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def __getnewargs__(self) -> tuple:
        # pickle (a spec sent to a rank) rebuilds through ``__new__``
        return tuple(self)


def _batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# (regex on joined path, spec of ndim: ndim -> P)
# paths look like: blocks/0/attn/wq, blocks/2/moe/w_gate, tail/0/mlp/w_up...
def param_rules(cfg: ModelConfig):
    d = "data"
    m = "model"

    def last2(nd, a, b):
        """spec with last two dims (a, b), leading dims (layer-stack) None."""
        return P(*([None] * (nd - 2) + [a, b]))

    def last3(nd, a, b, c):
        return P(*([None] * (nd - 3) + [a, b, c]))

    rules = [
        # embeddings: (V, d)
        (r"embeddings/embed$", lambda nd: P(m, d)),
        (r"embeddings/unembed$", lambda nd: P(d, m)),
        # attention projections: wq/wk/wv (d, H*hd), wo (H*hd, d)
        (r"attn/wq$", lambda nd: last2(nd, d, m)),
        (r"attn/wk$", lambda nd: last2(nd, d, None)),
        (r"attn/wv$", lambda nd: last2(nd, d, None)),
        (r"attn/wo$", lambda nd: last2(nd, m, d)),
        # MLA
        (r"mla/w_dq$", lambda nd: last2(nd, d, None)),
        (r"mla/w_uq$", lambda nd: last3(nd, None, m, None)),
        (r"mla/wq$", lambda nd: last3(nd, d, m, None)),
        (r"mla/w_dkv$", lambda nd: last2(nd, d, None)),
        (r"mla/w_uk$", lambda nd: last3(nd, None, m, None)),
        (r"mla/w_uv$", lambda nd: last3(nd, None, m, None)),
        (r"mla/wo$", lambda nd: last2(nd, m, d)),
        # MLP: (d, f) / (f, d)
        (r"mlp/w_gate$", lambda nd: last2(nd, d, m)),
        (r"mlp/w_up$", lambda nd: last2(nd, d, m)),
        (r"mlp/w_down$", lambda nd: last2(nd, m, d)),
        # MoE: router (d, E); experts (E, d, f)/(E, f, d)
        (r"moe/router$", lambda nd: last2(nd, d, None)),
        (r"moe/w_gate$", lambda nd: last3(nd, m, d, None)),
        (r"moe/w_up$", lambda nd: last3(nd, m, d, None)),
        (r"moe/w_down$", lambda nd: last3(nd, m, None, d)),
        # Mamba2
        (r"mamba/in_proj$", lambda nd: last2(nd, d, m)),
        (r"mamba/out_proj$", lambda nd: last2(nd, m, d)),
        (r"mamba/conv_w$", lambda nd: last2(nd, None, m)),
        (r"mamba/conv_b$", lambda nd: P(*([None] * (nd - 1) + [m]))),
        (r"mamba/out_norm", lambda nd: P(*([None] * (nd - 1) + [m]))),
        # RG-LRU
        (r"rglru/w_x$", lambda nd: last2(nd, d, m)),
        (r"rglru/w_gate$", lambda nd: last2(nd, d, m)),
        (r"rglru/(wa|wi)$", lambda nd: last2(nd, None, m)),
        (r"rglru/(ba|bi|lam|conv_b)$", lambda nd: P(*([None] * (nd - 1) + [m]))),
        (r"rglru/conv_w$", lambda nd: last2(nd, None, m)),
        (r"rglru/w_out$", lambda nd: last2(nd, m, d)),
    ]
    return rules


def _mesh_sizes(mesh) -> dict:
    return dict(mesh.shape)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def fit_spec(spec: P, shape, mesh) -> P:
    """Demote axes that don't divide their dim (the EC page layout needs
    exact divisibility).  Axes absent from the mesh are dropped."""
    sizes = _mesh_sizes(mesh)

    def present(axes):
        if isinstance(axes, str):
            return axes if axes in sizes else None
        kept = tuple(a for a in axes if a in sizes)
        return kept if kept else None

    out = []
    for i, axes in enumerate(spec):
        if axes is not None:
            axes = present(axes)
        if axes is None or i >= len(shape):
            out.append(None if i >= len(shape) else axes)
            continue
        if shape[i] % _axis_size(mesh, axes) == 0 and shape[i] > 0:
            out.append(axes)
        elif not isinstance(axes, str) and axes:
            # tuple axes: try a shrinking prefix, e.g. ("pod","data")->("data",)
            cand = tuple(axes)
            while cand and shape[i] % _axis_size(mesh, cand) != 0:
                cand = cand[1:]
            out.append(cand if cand else None)
        else:
            out.append(None)
    return P(*out)


def param_specs(cfg: ModelConfig, params_shape, mesh) -> dict:
    """P tree matching a params tree (leaves need only ``.shape``)."""
    rules = param_rules(cfg)

    def spec_for(path, leaf):
        ps = path_str(path)
        nd = len(leaf.shape)
        for pat, make_spec in rules:
            if re.search(pat, ps):
                spec = make_spec(nd)
                if len(spec) > nd:  # guard tiny/degenerate leaves
                    return P()
                return fit_spec(spec, leaf.shape, mesh)
        return P()  # replicate

    return tree_map_with_path(spec_for, params_shape)


def batch_specs(cfg: ModelConfig, batch_shape, mesh) -> dict:
    """Input batch: leading batch dim -> (pod, data); mrope positions have
    batch second; scalars replicated."""
    b = _batch_axes(mesh)

    def spec_for(path, leaf):
        ps = path_str(path)
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        if "positions" in ps and nd == 3:   # (3, B, S)
            return fit_spec(P(None, b, None), leaf.shape, mesh)
        return fit_spec(P(*([b] + [None] * (nd - 1))), leaf.shape, mesh)

    return tree_map_with_path(spec_for, batch_shape)


def cache_specs(cfg: ModelConfig, cache_shape, mesh) -> dict:
    """Decode caches: batch -> (pod,data); the long sequence axis of
    attention KV / MLA latents -> "model" (sequence-sharded decode)."""
    b = _batch_axes(mesh)
    m = "model"

    def spec_for(path, leaf):
        ps = path_str(path)
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        # leading dim may be the layer stack (repeats): detect via path
        off = 1 if ps.startswith("blocks/") else 0
        spec = [None] * nd
        spec[off] = b                       # batch
        if re.search(r"/(k|v|latent|k_rope|k_scale|v_scale)$", ps) \
                and nd >= off + 3:
            spec[off + 1] = m               # sequence axis
        elif re.search(r"/ssm$", ps) and nd >= off + 3:
            spec[off + 1] = m               # ssm heads
        elif re.search(r"/h$", ps):
            spec[off + 1] = m               # rg-lru width
        elif re.search(r"/conv$", ps) and nd >= off + 3:
            spec[off + 2] = m               # conv channels
        return fit_spec(P(*spec), leaf.shape, mesh)

    return tree_map_with_path(spec_for, cache_shape)


# ---------------------------------------------------------------------------
# local views (what shard_map hands each position)
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple:
    """The mesh axes one entry of a ``P`` names, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_view(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """Every position's block of tensor ``t`` as one view of shape
    ``(*mesh sizes in axis order, *block shape)``: index ``[i, j, ...]``
    is the block at mesh coordinate (i, j, ...).  A dimension split over
    several axes takes the first as the major one; a mesh axis the spec
    does not name replicates the block (a stride-0 dimension).  ``t``
    must be contiguous (parameters and caches are)."""
    names = tuple(mesh.axis_names)
    sizes = _mesh_sizes(mesh)
    split, axis_dim, local_dims = [], {}, []
    for i, n in enumerate(t.shape):
        axes = entry_axes(spec[i] if i < len(spec) else None)
        for a in axes:
            if a not in sizes or a in axis_dim:
                raise ValueError(f"spec {spec}: axis {a!r} on mesh {names}")
            axis_dim[a] = len(split)
            split.append(sizes[a])
        local_dims.append(len(split))
        split.append(n // math.prod(sizes[a] for a in axes))
    v = t.view(split) if split else t.reshape(())
    mapped = [a for a in names if a in axis_dim]
    v = v.permute([axis_dim[a] for a in mapped] + local_dims)
    for idx, a in enumerate(names):
        if a not in axis_dim:
            v = v.unsqueeze(idx)
    return v.expand(*(sizes[a] for a in names), *v.shape[len(names):])


def local_leaf_view(leaf, spec: P, mesh):
    """``local_view`` of a leaf; a ``Stacked`` leaf (its stacked axis never
    split) gives a ``Stacked`` of its parts' views."""
    if isinstance(leaf, Stacked):
        if spec and spec[0] is not None:
            raise ValueError(f"spec {spec} splits a stacked leaf's "
                             f"repeats axis")
        return Stacked(local_view(p, P(*spec[1:]), mesh)
                       for p in leaf.parts)
    return local_view(leaf, spec, mesh)


def local_block(leaf, spec: P, mesh, coords):
    """The block of a leaf that the position at mesh coordinate ``coords``
    holds: ``local_leaf_view`` indexed there, a view of the leaf (a
    ``Stacked`` of its parts' blocks for a ``Stacked`` leaf)."""
    at = tuple(int(c) for c in coords)
    view = local_leaf_view(leaf, spec, mesh)
    if isinstance(view, Stacked):
        return Stacked(v[at] for v in view.parts)
    return view[at]


def whole_leaf(t: torch.Tensor, spec: P, comms) -> torch.Tensor:
    """The whole tensor of which ``t`` is a rank's block by ``spec``:
    along each dimension, the blocks of its axes all-gathered over the
    rank's communicators (``comms``, a ``ranks.AxisComms``), the minor
    axis first.  Every rank of the mesh must call it."""
    cols = {c.axis: c for c in comms.columns()}
    for i, entry in enumerate(spec):
        for axis in reversed(entry_axes(entry)):
            g = cols[axis].all_gather(t.contiguous()).movedim(0, i)
            t = g.reshape(*t.shape[:i], -1, *t.shape[i + 1:])
    return t


def writes_block(spec: P, mesh, coords) -> bool:
    """Whether the position at ``coords`` is the one that writes its block
    of a leaf laid out by ``spec`` in place: a block is shared by the
    positions along every mesh axis the spec does not name, and the
    first of them (coordinate 0 on each such axis) writes it."""
    named = {a for entry in spec for a in entry_axes(entry)}
    return all(c == 0 for a, c in zip(mesh.axis_names, coords)
               if a not in named)
