"""Checkpointing: disk snapshots + EC in-memory protection.

The port of the JAX package's ``train/checkpoint.py``.

Disk path (cold): the reference's format - one ``.npy`` per leaf in the
reference's leaf order, named by its path joined with "_", and a
``manifest.json`` ({"step", "leaves": [{"file", "name", "shape",
"dtype"}]}), written to a tmp dir and atomically renamed, GC'd to
``keep_last``.  bfloat16 leaves are stored as their raw bytes (uint8, the
last dimension doubled) under the dtype name "bfloat16", so a checkpoint
written by either package restores in the other.  A ``Stacked`` leaf is
written stacked, as the reference holds it.

From ranks (``specs`` and ``comms``, a rank's ``ranks.AxisComms``): the
tree holds the rank's blocks, laid out by ``specs``.  ``save_checkpoint``
gathers each leaf whole over the axes its spec splits (every rank takes
part) and the rank at coordinate 0 writes it, in the same format;
``restore_checkpoint`` reads each whole leaf on every rank and copies its
``sharding.local_block`` into the rank's block.

EC path (hot): ``ECCheckpoint`` wraps ``distributed.ecstore.ECStateStore``;
parity lives on the state's device and is refreshed every step.  Recovery
reconstructs a lost data-axis position from k survivors without touching
disk.  Without a ``comm`` the checkpoint holds every mesh position stacked
on one card; with one (``distributed.ranks.RankComm``) it is one rank's:
``create``/``update``/``stage``/``commit``/``reconstruct`` take the rank's
local tree (``sharding.local_block``) and keep its pages and parity.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..distributed.ecstore import ECConfig, ECStateStore
from ..distributed.sharding import local_block, whole_leaf
from ..tree import Stacked, leaves, leaves_with_path


# ---------------------------------------------------------------------------
# disk checkpoints
# ---------------------------------------------------------------------------

_NATIVE_DTYPES = {"float64", "float32", "float16", "int64", "int32",
                  "int16", "int8", "uint64", "uint32", "uint16", "uint8",
                  "bool"}


def _leaf_paths(tree):
    return [("_".join(str(p) for p in path), leaf)
            for path, leaf in leaves_with_path(tree)]


def _to_numpy(leaf) -> np.ndarray:
    """A leaf on the host; bfloat16 as its int16 bit patterns."""
    t = leaf.materialize() if isinstance(leaf, Stacked) else leaf
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _gathered_leaves(tree, specs, comms):
    """(name, whole leaf) of the rank blocks of ``tree``, one at a time."""
    for (name, leaf), spec in zip(_leaf_paths(tree), leaves(specs)):
        if isinstance(leaf, Stacked):
            inner = type(spec)(*spec[1:])
            yield name, Stacked(whole_leaf(p, inner, comms)
                                for p in leaf.parts)
        else:
            yield name, whole_leaf(leaf, spec, comms)


def save_checkpoint(ckpt_dir: str, step: int, tree, keep_last: int = 3, *,
                    specs=None, comms=None):
    """Write ``tree`` as step ``step`` (module notes); with ``specs`` and
    ``comms``, ``tree`` is a rank's blocks and the rank at coordinate 0
    writes the whole leaves (every rank must call it)."""
    if comms is not None:
        return _save_from_ranks(ckpt_dir, step, tree, keep_last, specs,
                                comms)
    return _save(ckpt_dir, step, _leaf_paths(tree), keep_last)


def _save_from_ranks(ckpt_dir, step, tree, keep_last, specs, comms):
    """Rank 0 writes; every rank takes part in every leaf's gathers, and
    none returns before the checkpoint is on disk."""
    import torch.distributed as dist
    named = _gathered_leaves(tree, specs, comms)
    final = None
    if not any(comms.coords):
        final = _save(ckpt_dir, step, named, keep_last)
    else:
        for _ in named:
            pass
    if dist.is_initialized():
        dist.barrier()
    return final


def _save(ckpt_dir: str, step: int, named_leaves, keep_last: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = []
    for i, (name, leaf) in enumerate(named_leaves):
        arr = _to_numpy(leaf)
        fn = f"{i:05d}.npy"
        logical = _dtype_name(leaf)
        shape = list(arr.shape)
        if logical not in _NATIVE_DTYPES:
            # bfloat16: persist the raw bytes
            arr = arr.view(np.uint8) if arr.ndim else \
                np.frombuffer(arr.tobytes(), np.uint8)
        np.save(os.path.join(tmp, fn), arr)
        manifest.append({"file": fn, "name": name, "shape": shape,
                         "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def _from_numpy(a: np.ndarray, meta: dict) -> torch.Tensor:
    if meta["dtype"] == "bfloat16":
        bits = np.frombuffer(a.tobytes(), np.int16).reshape(meta["shape"])
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if meta["dtype"] not in _NATIVE_DTYPES:
        raise TypeError(f"{meta['name']}: dtype {meta['dtype']} is not "
                        f"supported")
    return torch.from_numpy(np.array(a).reshape(meta["shape"]))


def restore_checkpoint(ckpt_dir: str, step: int, tree_like, *, specs=None,
                       mesh=None, coords=None):
    """Restore into the tensors of ``tree_like`` (shapes must match), in
    place, each cast to its leaf's dtype; returns ``tree_like``.  With
    ``specs``, ``mesh`` and ``coords``, ``tree_like`` is the blocks of the
    rank at ``coords`` and each takes its ``local_block`` of the whole
    leaf."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    targets = leaves(tree_like)
    assert len(manifest["leaves"]) == len(targets), \
        "checkpoint/tree structure mismatch"
    spec_leaves = leaves(specs) if specs is not None else [None] * len(
        targets)
    for meta, leaf, spec in zip(manifest["leaves"], targets, spec_leaves):
        t = _from_numpy(np.load(os.path.join(d, meta["file"])), meta)
        if spec is not None:
            t = local_block(t, spec, mesh, coords)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{meta['name']}: shape {tuple(t.shape)}, "
                             f"expected {tuple(leaf.shape)}")
        with torch.no_grad():
            leaf.copy_(t.to(leaf.dtype).to(leaf.device))
    return tree_like


# ---------------------------------------------------------------------------
# EC in-memory checkpoints
# ---------------------------------------------------------------------------

class ECCheckpoint:
    """Hot, in-memory, erasure-coded copy of training state.

    ``create``, ``update(old, new)`` and ``reconstruct`` are the
    reference's.  For state updated in place, ``stage(state)`` packs the
    old bytes into a page buffer kept between steps and ``commit(state)``
    XORs the new bytes into it and folds the delta into the parity: no
    second copy of the state, one kernel launch per update.  ``comm``:
    one rank's checkpoint (module notes)."""

    def __init__(self, mesh, state_specs, cfg: ECConfig | None = None,
                 comm=None):
        self.store = ECStateStore(mesh, state_specs, cfg, comm)
        self.parity = None
        self._pages = None

    def create(self, state):
        self._pages = self.store.pack(state)
        self.parity = self.store.zero_parity(self._pages)
        self.store.fold(self._pages, self.parity)
        return self.parity

    def update(self, old_state, new_state):
        assert self.parity is not None, "create() first"
        self.parity = self.store.delta_update(old_state, new_state,
                                              self.parity)
        return self.parity

    def stage(self, state):
        """Pack the state's bytes before an in-place update."""
        assert self.parity is not None, "create() first"
        self.store.pack(state, out=self._pages)

    def commit(self, state):
        """After the in-place update: parity ^= gamma·(old ⊕ new)."""
        self.store.pack(state, out=self._pages, xor=True)
        self.store.fold(self._pages, self.parity)
        return self.parity

    def reconstruct(self, state, failed_data_index: int):
        """Pages of the failed data-axis position (see ecstore docs)."""
        assert self.parity is not None
        return self.store.reconstruct(state, self.parity, failed_data_index)
