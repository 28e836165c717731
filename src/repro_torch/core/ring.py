"""Elastic key placement: pluggable Placement interface + consistent-hash ring.

The sharded cluster (core/shard.py) used to freeze the key->shard map at
construction (FNV-1a mod S), so it could neither grow/shrink nor escape a
Zipf hot shard.  This module makes placement a first-class, *pluggable*
policy:

* ``Placement`` — the interface every policy implements: ``shard_for``
  routes a key, ``add_shard``/``remove_shard`` change membership, and
  (optionally) ``set_weight`` biases capacity per shard.
* ``ModPlacement`` — the original FNV-1a-mod policy, generalized to an
  arbitrary active-shard list.  Membership changes remap ``h % S`` for a
  new S, i.e. a near-full reshuffle — it is the *naive baseline* the
  rebalance benchmark compares against.
* ``RingPlacement`` — a deterministic consistent-hash ring with virtual
  nodes and per-shard weights.  Each shard owns ``round(vnodes * weight)``
  points at ``fnv1a("ring:<shard>:<vnode>")``; a key hashes onto the ring
  and belongs to the clockwise-next point's shard.  Adding a shard steals
  only ~1/S of the key space (minimal movement); shrinking a hot shard's
  weight sheds a proportional slice of its arcs — the lever the
  skew-aware ``Rebalancer`` (core/rebalance.py) pulls.

Everything is pure hashing over ``index.fnv1a`` — no RNG, no process
state — so placements are bit-identical across processes and runs
(required: proxies, the coordinator, and offline tools must agree on
routing without coordination).

Selection: ``make_placement(spec, num_shards)``; ``spec=None`` reads
``$MEMEC_PLACEMENT`` (``mod`` | ``ring`` | ``ring:<vnodes>``), default
``mod`` (byte-compatible with the pre-elasticity cluster).
"""
from __future__ import annotations

import bisect
import os

from .index import fnv1a

# key-side hash seed: must match shard.SHARD_SEED so ModPlacement stays
# bit-identical with the historical shard_for_key routing
KEY_SEED = 0x01000193
# ring-point hash seed: independent of key hashing and of the per-shard
# two-stage stripe hashing (stripe.py)
RING_SEED = 0x8FE3C9A1
DEFAULT_VNODES = 64


def key_point(key: bytes) -> int:
    """A key's 64-bit position (shared by every placement policy)."""
    return fnv1a(key, seed=KEY_SEED)


class Placement:
    """Key -> shard-id routing policy with elastic membership.

    Shard ids are stable labels (indices into ``ShardedCluster.shards``);
    removing a shard retires its id — ids are never renumbered.
    """

    kind = "abstract"
    supports_weights = False

    @property
    def shard_ids(self) -> tuple[int, ...]:
        """Active shard ids, ascending."""
        raise NotImplementedError

    @property
    def num_shards(self) -> int:
        return len(self.shard_ids)

    def shard_for(self, key: bytes) -> int:
        raise NotImplementedError

    def add_shard(self, shard: int, weight: float = 1.0) -> int:
        raise NotImplementedError

    def remove_shard(self, shard: int) -> None:
        raise NotImplementedError

    def set_weight(self, shard: int, weight: float) -> None:
        raise NotImplementedError(f"{self.kind} placement has no weights")

    def weight_of(self, shard: int) -> float:
        return 1.0

    def describe(self) -> str:
        return f"{self.kind}({self.num_shards} shards)"


class ModPlacement(Placement):
    """FNV-1a mod over the active-shard list (the historical policy).

    For the construction-time ``[0..S)`` membership this is bit-identical
    to the original ``shard_for_key``.  Membership changes rehash ``h %
    S`` with a new modulus, moving ~(S-1)/S of the keys — the full-
    reshuffle baseline for the migration benchmarks.
    """

    kind = "mod"

    def __init__(self, num_shards: int = 1, shard_ids=None):
        self.active = (sorted(shard_ids) if shard_ids is not None
                       else list(range(num_shards)))
        if not self.active:
            raise ValueError("need at least one shard")

    @property
    def shard_ids(self) -> tuple[int, ...]:
        return tuple(self.active)

    def shard_for(self, key: bytes) -> int:
        if len(self.active) == 1:
            return self.active[0]
        return self.active[key_point(key) % len(self.active)]

    def add_shard(self, shard: int, weight: float = 1.0) -> int:
        if shard in self.active:
            raise ValueError(f"shard {shard} already active")
        bisect.insort(self.active, shard)
        return shard

    def remove_shard(self, shard: int) -> None:
        if shard not in self.active:
            raise ValueError(f"no active shard {shard}")
        if len(self.active) == 1:
            raise ValueError("cannot remove the last shard")
        self.active.remove(shard)


class RingPlacement(Placement):
    """Deterministic consistent-hash ring with virtual nodes and weights.

    Shard ``s`` with weight ``w`` owns ``max(1, round(vnodes * w))``
    points at ``fnv1a(b"ring:<s>:<j>", RING_SEED)``; a key belongs to the
    shard of the first point clockwise from ``key_point(key)``.  Adding a
    shard steals ~1/(S+1) of every incumbent's arc mass; removing one
    spills its arcs onto the clockwise successors; reweighting moves only
    the arc mass the weight delta implies.
    """

    kind = "ring"
    supports_weights = True

    def __init__(self, num_shards: int = 1, vnodes: int = DEFAULT_VNODES,
                 weights: dict[int, float] | None = None, shard_ids=None):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        ids = (sorted(shard_ids) if shard_ids is not None
               else list(range(num_shards)))
        if not ids:
            raise ValueError("need at least one shard")
        self.weights: dict[int, float] = {s: 1.0 for s in ids}
        if weights:
            for s, w in weights.items():
                self._check_weight(w)
                self.weights[s] = float(w)
        self._rebuild()

    @staticmethod
    def _check_weight(w: float):
        if not (w > 0):
            raise ValueError(f"weight must be > 0, got {w}")

    def _points_of(self, shard: int) -> int:
        return max(1, round(self.vnodes * self.weights[shard]))

    def _rebuild(self):
        pts = []
        for s in sorted(self.weights):
            for j in range(self._points_of(s)):
                pts.append((fnv1a(b"ring:%d:%d" % (s, j), seed=RING_SEED), s))
        pts.sort()  # (point, shard) — shard id breaks 64-bit point ties
        self._points = [p for p, _ in pts]
        self._owners = [s for _, s in pts]

    @property
    def shard_ids(self) -> tuple[int, ...]:
        return tuple(sorted(self.weights))

    def shard_for(self, key: bytes) -> int:
        i = bisect.bisect_right(self._points, key_point(key))
        return self._owners[i % len(self._owners)]

    def add_shard(self, shard: int, weight: float = 1.0) -> int:
        if shard in self.weights:
            raise ValueError(f"shard {shard} already active")
        self._check_weight(weight)
        self.weights[shard] = float(weight)
        self._rebuild()
        return shard

    def remove_shard(self, shard: int) -> None:
        if shard not in self.weights:
            raise ValueError(f"no active shard {shard}")
        if len(self.weights) == 1:
            raise ValueError("cannot remove the last shard")
        del self.weights[shard]
        self._rebuild()

    def set_weight(self, shard: int, weight: float) -> None:
        if shard not in self.weights:
            raise ValueError(f"no active shard {shard}")
        self._check_weight(weight)
        self.weights[shard] = float(weight)
        self._rebuild()

    def weight_of(self, shard: int) -> float:
        return self.weights[shard]

    def arc_fractions(self) -> dict[int, float]:
        """Fraction of the 64-bit ring each shard owns (diagnostics)."""
        span = 1 << 64
        out = {s: 0 for s in self.weights}
        prev = self._points[-1] - span  # wrap-around arc
        for p, s in zip(self._points, self._owners):
            out[s] += p - prev
            prev = p
        return {s: v / span for s, v in out.items()}

    def describe(self) -> str:
        return (f"ring({self.num_shards} shards, {self.vnodes} vnodes, "
                f"{len(self._points)} points)")


def make_placement(spec=None, num_shards: int = 1) -> Placement:
    """Placement factory.  ``spec``: a ``Placement`` instance (adopted as
    is; its membership must already cover ``[0, num_shards)``), ``"mod"``,
    ``"ring"``, ``"ring:<vnodes>"``, or None (``$MEMEC_PLACEMENT``,
    default ``mod`` — the historical routing)."""
    if isinstance(spec, Placement):
        if set(spec.shard_ids) != set(range(num_shards)):
            raise ValueError(
                f"placement covers shards {spec.shard_ids}, cluster has "
                f"[0, {num_shards})")
        return spec
    if spec is None:
        spec = os.environ.get("MEMEC_PLACEMENT") or "mod"
    name, _, arg = str(spec).partition(":")
    if name == "mod":
        return ModPlacement(num_shards)
    if name == "ring":
        vnodes = int(arg) if arg else DEFAULT_VNODES
        return RingPlacement(num_shards, vnodes=vnodes)
    raise ValueError(f"unknown placement {spec!r} (mod | ring | ring:<vnodes>)")
