"""State trees in the JAX package's layout.

The reference keeps a model's parameters, its optimizer state and its
serving cache as nested dicts and lists whose leaves are arrays.
``jax.tree.leaves`` visits them with dict keys sorted, lists in order and
``None`` skipped, and its erasure-coded state store, sharding rules,
optimizers and disk checkpoints all walk that order.  The port walks the
same trees with ``leaves_with_path``.

The port's ``Model`` keeps one flat layer list, where the reference
stacks each unit position's layers on a leading ``repeats`` axis.  Such a
leaf is a ``Stacked`` here: the per-repeat tensors themselves, in repeat
order, never copied into one tensor (at full width that copy would be
another 8 GB).  ``models.convert.param_tree`` and ``Model.cache_tree``
build the trees.
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch


class Stacked:
    """One leaf of the reference's tree stacked on a leading axis, held as
    its parts: ``shape`` is ``(len(parts),) + parts[0].shape``."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)
        if not self.parts:
            raise ValueError("a stacked leaf needs at least one part")
        first = self.parts[0]
        for p in self.parts[1:]:
            if (p.shape, p.dtype, p.device) != (first.shape, first.dtype,
                                                first.device):
                raise ValueError("stacked parts differ in shape, dtype or "
                                 "device")

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def materialize(self) -> torch.Tensor:
        """The leaf as one tensor (a copy)."""
        return torch.stack(self.parts)

    def copy_(self, src) -> "Stacked":
        """Copy a stacked tensor (or another ``Stacked``) into the parts."""
        for r, p in enumerate(self.parts):
            p.copy_(src.parts[r] if isinstance(src, Stacked) else src[r])
        return self


def _is_node(x) -> bool:
    # exact types: a tuple subclass (a sharding spec) is a leaf
    return type(x) in (dict, list, tuple)


def leaves_with_path(tree, prefix: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) in ``jax.tree_util.tree_flatten_with_path`` order: dict
    keys sorted, sequences in order, ``None`` skipped.  A path is a tuple
    of dict keys and sequence indices."""
    if tree is None:
        return
    if _is_node(tree):
        items = (sorted(tree.items()) if isinstance(tree, dict)
                 else enumerate(tree))
        for key, sub in items:
            yield from leaves_with_path(sub, prefix + (key,))
        return
    yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_str(path) -> str:
    """``"blocks/0/attn/wq"``: the reference's ``sharding.path_str``."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; ``None`` stays ``None``."""
    if tree is None:
        return None
    if _is_node(tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v, *(r[k] for r in rest))
                    for k, v in tree.items()}
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    if tree is None:
        return None
    if _is_node(tree):
        if isinstance(tree, dict):
            return {k: tree_map_with_path(fn, v, prefix + (k,))
                    for k, v in tree.items()}
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def map_parts(fn: Callable, *leaves_):
    """``fn`` over the tensors of matching leaves: part by part where the
    first is ``Stacked`` (the result is ``Stacked``), else once."""
    if isinstance(leaves_[0], Stacked):
        return Stacked(fn(*ps) for ps in zip(*(l.parts for l in leaves_)))
    return fn(*leaves_)


def tensors(leaf) -> list:
    """The tensors that hold a leaf: its parts, or itself."""
    return leaf.parts if isinstance(leaf, Stacked) else [leaf]


def materialize(leaf) -> torch.Tensor:
    return leaf.materialize() if isinstance(leaf, Stacked) else leaf
