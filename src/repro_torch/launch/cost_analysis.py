"""Cost analysis of a torch program: the counterpart of the JAX package's
``launch/hlo_analysis.py``.

The reference parses the post-SPMD HLO of a compiled step.  The port has
no HLO: it runs the step itself, eagerly, on ``meta`` tensors (nothing is
allocated; ``launch/dryrun.py``) or on the card, and counts what the torch
program does:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  matrix products (``mm``, ``bmm``, convolutions, ...) and kernel 11
  through its registered formula (``kernels.flash_attention``); elementwise
  work is not counted.  A ``torch.utils.checkpoint`` recompute runs again
  in the backward and counts again, as the reference's HLO holds it.
* bytes: every op's tensor operands and results (each view's own
  elements), as ``analyze`` counts operand and result bytes per
  instruction.  Views, ``empty`` and other metadata ops move nothing and
  count nothing.
* peak: the largest sum of live storages' bytes during the step, the
  arguments included (on the card, ``torch.cuda.memory_stats()``'s
  ``requested_bytes.all.peak``: the bytes asked of the caching allocator,
  before it rounds them into its blocks).
* collectives: bytes the mesh positions send each other, by kind, where
  the port moves a position's block to another explicitly
  (``distributed.collectives.note_permute``/``note_send``: ``ring_shift``,
  the stacked EC store's rotations, rolled XORs and rebuild gathers, the
  ``collective-permute``s; and every send of a rank's communicator,
  ``distributed/ranks.py``: its shifts, ``all-gather``s and
  ``all-reduce``s).  On one card nothing crosses a link; the count is
  what a mesh of cards would send.

Argument bytes per device come from ``distributed/sharding.py``'s specs:
each leaf's local block on the mesh (``argument_bytes``).
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..distributed import collectives
from ..distributed.sharding import local_leaf_view
from ..tree import Stacked, leaves

# ops that allocate or move no bytes of their own
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided",
         "empty_like", "detach", "lift_fresh"}


def _tensors(items) -> list:
    """The tensors among ``items`` and the lists or tuples in them (an
    op's arguments and results nest no deeper)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _ByteCounter(TorchDispatchMode):
    """Bytes of every op's operands and results, and the peak of live
    storages' bytes."""

    def __init__(self, live: list):
        super().__init__()
        self.bytes = 0
        self._live: dict = {}
        self.current = 0
        for t in live:
            self._track(t)
        self.peak = self.current

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        size = st.nbytes()
        self._live[key] = size
        self.current += size
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.current -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out if isinstance(out, (list, tuple)) else [out])
        if not (func.is_view or func._schema.name.split("::")[-1] in _FREE):
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) + sum(
                _nbytes(t) for t in _tensors((kwargs or {}).values())) + \
                sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.current)
        return out


class Count:
    """``with Count(live) as c: step()`` counts the step: ``c.flops``,
    ``c.flops_by_op``, ``c.bytes``, ``c.peak_bytes``
    (``live`` tensors included), ``c.collective_bytes`` and
    ``c.collective_counts`` (bytes sent to other mesh positions and
    moves, by collective kind), ``c.permute_bytes`` and ``c.permutes``
    (those of the ``collective-permute``s).  ``live``: the tensors that
    exist before the step (its arguments)."""

    def __init__(self, live=()):
        self._live = list(live)

    def __enter__(self) -> "Count":
        self.collective_bytes: dict = {}
        self.collective_counts: dict = {}
        self._flops = FlopCounterMode(display=False)
        self._bytes = _ByteCounter(self._live)
        self._rec = collectives.recording(self._note)
        self._rec.__enter__()
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def _note(self, nbytes: int, kind: str) -> None:
        self.collective_bytes[kind] = self.collective_bytes.get(kind, 0) \
            + nbytes
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) \
            + 1

    @property
    def permute_bytes(self) -> int:
        return self.collective_bytes.get(collectives.PERMUTE, 0)

    @property
    def permutes(self) -> int:
        return self.collective_counts.get(collectives.PERMUTE, 0)

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self._rec.__exit__(*exc)
        self.flops = int(self._flops.get_total_flops())
        self.flops_by_op = {str(k): int(v) for k, v in
                            self._flops.get_flop_counts()
                            .get("Global", {}).items()}
        self.bytes = self._bytes.bytes
        self.peak_bytes = self._bytes.peak
        self._live = []
        return False


def _leaf_local_bytes(leaf, spec, mesh) -> int:
    """Bytes of one position's block of ``leaf`` (a tensor or ``Stacked``)
    under ``spec`` on ``mesh``."""
    view = local_leaf_view(leaf, spec, mesh)
    nd = len(mesh.axis_names)
    return sum(math.prod(v.shape[nd:]) * v.element_size()
               for v in (view.parts if isinstance(view, Stacked) else [view]))


def argument_bytes(trees_and_specs, mesh) -> int:
    """Bytes one device holds of the arguments: ``[(tree, specs), ...]``,
    each leaf's local block under its spec (a 0-d leaf whole)."""
    total = 0
    for tree, specs in trees_and_specs:
        for leaf, spec in zip(leaves(tree), leaves(specs)):
            total += _leaf_local_bytes(leaf, spec, mesh)
    return total


def storage_bytes(ts) -> int:
    """Bytes of the distinct storages of the tensors ``ts``."""
    seen, total = set(), 0
    for t in ts:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total
