"""Load the JAX package's parameter tree into the port's ``Model``.

The reference's ``Model.init`` returns nested dicts and lists:

    {"embeddings": {"embed", "unembed"}, "final_norm": {"scale"},
     "blocks": [one dict per unit position, every leaf stacked on a
                leading ``repeats`` axis, or None],
     "tail":   [one dict per remainder layer]}

``params_from_jax`` takes that tree with numpy leaves (what
``jax.tree.map(np.asarray, params)`` gives), unstacks the ``repeats``
axis into the port's flat layer list (unit position ``u`` of repeat
``r`` is layer ``r * len(unit) + u``, the tail after), and copies every
leaf into the parameter of the same name.  bf16 leaves arrive as
``ml_dtypes`` arrays; they are reinterpreted bit for bit through int16,
so neither JAX nor ``ml_dtypes`` is imported here.

``param_tree`` goes the other way without copying: the model's own
parameters arranged as that tree, what the training step, the optimizers,
the disk checkpoints and the erasure-coded state store walk.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tree import Stacked, tree_map
from .transformer import Model


def _nest(named: dict) -> dict:
    """{"attn.wq": t, ...} -> {"attn": {"wq": t}, ...}."""
    out: dict = {}
    for name, t in named.items():
        *heads, last = name.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


def param_tree(model: Model) -> dict:
    """The model's parameters as the reference's ``Model.init`` tree
    (module notes), leaves the model's own parameters: a ``blocks`` leaf
    is a ``Stacked`` of the repeats' tensors, never a copy."""
    n, R = len(model.unit), model.repeats

    def layer(i):
        return _nest(dict(model.layers[i].named_parameters()))

    blocks = [tree_map(lambda *ts: Stacked(ts),
                       *(layer(r * n + u) for r in range(R)))
              if R else None for u in range(n)]
    return {"embeddings": _nest(dict(model.embeddings.named_parameters())),
            "final_norm": _nest(dict(model.final_norm.named_parameters())),
            "blocks": blocks,
            "tail": [layer(i) for i in range(R * n, len(model.layers))]}


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}.{key}" if prefix else key, out)
    else:
        out[prefix] = tree


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr, order="C")   # a writable copy: jax arrays are not
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _named_leaves(model: Model, tree: dict) -> dict:
    """The reference tree's leaves under the port's parameter names."""
    n_unit = len(model.unit)
    leaves: dict = {}
    for top in ("embeddings", "final_norm"):
        if top in tree:
            _flatten(tree[top], top, leaves)
    extra = set(tree) - {"embeddings", "final_norm", "blocks", "tail"}
    if extra:
        raise KeyError(f"unexpected top-level keys {sorted(extra)}")
    blocks = tree.get("blocks", [])
    if len(blocks) != n_unit:
        raise KeyError(f"{len(blocks)} block entries for a unit of "
                       f"{n_unit} layers")
    for u, block in enumerate(blocks):
        if block is None:
            continue
        stacked: dict = {}
        _flatten(block, "", stacked)
        for sub, arr in stacked.items():
            arr = np.asarray(arr)
            if arr.shape[0] != model.repeats:
                raise ValueError(f"blocks[{u}].{sub}: leading axis "
                                 f"{arr.shape[0]}, expected {model.repeats}"
                                 f" repeats")
            for r in range(model.repeats):
                leaves[f"layers.{r * n_unit + u}.{sub}"] = arr[r]
    base = model.repeats * n_unit
    for i, layer in enumerate(tree.get("tail", [])):
        _flatten(layer, f"layers.{base + i}", leaves)
    return leaves


@torch.no_grad()
def params_from_jax(model: Model, tree: dict) -> Model:
    """Copy the reference's parameter tree (numpy leaves) into ``model``.

    Raises ``KeyError`` on a missing or extra key, ``ValueError`` on a
    shape mismatch and ``TypeError`` on a dtype mismatch; nothing is
    copied unless every leaf matches.  Returns ``model``."""
    leaves = _named_leaves(model, tree)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise KeyError(f"parameter tree does not match the model: missing "
                       f"{missing}, extra {extra}")
    tensors = {}
    for name, p in params.items():
        t = _tensor(leaves[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(p.shape)}")
        if t.dtype != p.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {p.dtype}")
        tensors[name] = t
    for name, t in tensors.items():
        params[name].copy_(t)
    return model
