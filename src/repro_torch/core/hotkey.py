"""Hot-key update tier: EWMA hot-set detection + bounded version buffers.

MemEC pays a full parity-delta round (engine call + m parity legs) on
every sealed-object UPDATE; under a Zipf workload the few hottest keys
dominate that cost.  The multi-version coding line of work (Ali &
Cadambe, PAPERS.md) shows update traffic can scale with delta entropy
across versions instead of object size.  This module is the host-side
state for that tier:

* ``HotKeyTracker`` — per-key EWMA-decayed update counters (the PR 3
  ``shard_ops`` idiom applied per key); a key is *hot* once its decayed
  score reaches ``threshold``.
* ``VersionBuffer`` — bounded map of hot sealed objects to their
  buffered version deltas (trimmed XOR segments against the then-current
  chunk bytes).  Successive versions XOR-chain: their fold is the
  collapsed base→latest delta, so N buffered updates cost ONE parity
  round at flush (``CodingEngine.submit_delta_collapse``).
* ``HotTier`` — the two plus the ``stats["hot_tier"]`` counters.

Everything here is deterministic (decay depends only on the op sequence)
and pure host bookkeeping — the flush/merge/barrier logic lives in
``core/store.py``, the collapse math in ``core/engine.py``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


def resolve_hot_keys(hot_key_threshold=None, env: str = "MEMEC_HOT_KEYS"
                     ) -> float:
    """Hot-tier knob: the ctor argument, else ``$MEMEC_HOT_KEYS``,
    defaulting to 0.0 (tier off — byte-identical baseline, zero state)."""
    if hot_key_threshold is None:
        raw = os.environ.get(env, "").strip()
        if not raw:
            return 0.0
        hot_key_threshold = float(raw)
    return max(0.0, float(hot_key_threshold))


class HotKeyTracker:
    """EWMA-decayed per-key update counters.

    ``touch(key)`` bumps the key's score by 1 after decaying it by
    ``0.5 ** (ops_since_last / HALFLIFE_OPS)`` — a steady updater's
    score converges near ``1 / (1 - 0.5**(gap/HALFLIFE_OPS))``, so the
    threshold is roughly "sustained share of the update stream".  Decay
    is a pure function of the op counter: replaying the same op sequence
    reproduces the same hot set exactly.
    """

    HALFLIFE_OPS = 64
    MAX_TRACKED = 4096

    def __init__(self, threshold: float):
        self.threshold = float(threshold)
        self.op = 0
        self._score: dict[bytes, tuple[float, int]] = {}

    def touch(self, key: bytes) -> bool:
        """Count one update to ``key``; True when the key is now hot."""
        self.op += 1
        s, last = self._score.get(key, (0.0, self.op))
        s = s * 0.5 ** ((self.op - last) / self.HALFLIFE_OPS) + 1.0
        self._score[key] = (s, self.op)
        if len(self._score) > self.MAX_TRACKED:
            self._prune()
        return s >= self.threshold

    def _prune(self) -> None:
        """Drop entries whose decayed score fell below 1 (i.e. colder
        than a single fresh touch); if everything is warm, keep the top
        half by (score, key) — deterministic tie-break."""
        op = self.op
        decayed = {k: sv * 0.5 ** ((op - lo) / self.HALFLIFE_OPS)
                   for k, (sv, lo) in self._score.items()}
        keep = [k for k, s in decayed.items() if s >= 1.0]
        if len(keep) > self.MAX_TRACKED // 2:
            keep = sorted(keep, key=lambda k: (-decayed[k], k))
            keep = keep[:self.MAX_TRACKED // 2]
        self._score = {k: (decayed[k], op) for k in keep}


@dataclasses.dataclass
class BufferedKey:
    """One hot sealed object's pending version deltas.

    ``versions`` holds trimmed XOR segments ``(chunk_off, seg)`` against
    the then-current chunk bytes (the data server mutated immediately;
    only the parity round was deferred), so XOR-folding them yields the
    collapsed base→latest delta.  ``sl``/``cid`` pin the stripe the
    deltas are owed to — they stay valid even if the key is later
    deleted or re-SET elsewhere (the obligation is per chunk region,
    not per key).
    """
    key: bytes
    sl: object
    cid: object
    versions: list[tuple[int, np.ndarray]]

    def extent(self) -> tuple[int, int]:
        """(min_off, max_end) union extent across buffered versions."""
        lo = min(off for off, _ in self.versions)
        hi = max(off + len(seg) for off, seg in self.versions)
        return lo, hi


class VersionBuffer:
    """Bounded, insertion-ordered map of buffered hot keys.

    ``append`` records one more version; exceeding ``max_keys`` evicts
    the oldest entry (returned so the caller can flush it).  A stripe
    index ``(list_id, stripe_id) -> keys`` backs the read barrier: any
    sealed-chunk race/decode on a stripe flushes that stripe's buffered
    keys first.
    """

    def __init__(self, max_keys: int = 64, max_versions: int = 8):
        self.max_keys = max(1, int(max_keys))
        self.max_versions = max(1, int(max_versions))
        self.entries: dict[bytes, BufferedKey] = {}
        self._by_stripe: dict[tuple, set[bytes]] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self.entries

    def get(self, key: bytes) -> BufferedKey | None:
        return self.entries.get(key)

    @staticmethod
    def stripe_of(sl, cid) -> tuple:
        return (id(sl), cid.stripe_id)

    def append(self, key: bytes, sl, cid, chunk_off: int, seg: np.ndarray
               ) -> tuple[BufferedKey, BufferedKey | None]:
        """Buffer one version delta; returns (entry, evicted-or-None)."""
        e = self.entries.get(key)
        if e is None:
            e = BufferedKey(key=key, sl=sl, cid=cid, versions=[])
            self.entries[key] = e
            self._by_stripe.setdefault(self.stripe_of(sl, cid),
                                       set()).add(key)
        e.versions.append((int(chunk_off), np.array(seg, dtype=np.uint8)))
        evicted = None
        if len(self.entries) > self.max_keys:
            oldest = next(iter(self.entries))
            if oldest != key:
                evicted = self.pop(oldest)
        return e, evicted

    def full(self, entry: BufferedKey) -> bool:
        return len(entry.versions) >= self.max_versions

    def pop(self, key: bytes) -> BufferedKey | None:
        e = self.entries.pop(key, None)
        if e is not None:
            sk = self.stripe_of(e.sl, e.cid)
            members = self._by_stripe.get(sk)
            if members is not None:
                members.discard(key)
                if not members:
                    del self._by_stripe[sk]
        return e

    def pop_stripe(self, sl, cid) -> list[BufferedKey]:
        """Drain every buffered key owing deltas to (sl, stripe) — the
        read-barrier drain, in insertion order for determinism."""
        members = self._by_stripe.get(self.stripe_of(sl, cid))
        if not members:
            return []
        keys = [k for k in self.entries if k in members]
        return [self.pop(k) for k in keys]

    def pop_all(self) -> list[BufferedKey]:
        out = [self.entries[k] for k in list(self.entries)]
        self.entries.clear()
        self._by_stripe.clear()
        return out


class HotTier:
    """Tracker + buffer + the ``stats["hot_tier"]`` counters."""

    def __init__(self, threshold: float, *, max_keys: int = 64,
                 max_versions: int = 8):
        self.tracker = HotKeyTracker(threshold)
        self.buffer = VersionBuffer(max_keys=max_keys,
                                    max_versions=max_versions)
        self.stats = {
            "buffered_updates": 0,      # sealed updates absorbed by the tier
            "flushes": 0,               # flush rounds (batched collapse calls)
            "flushed_keys": 0,          # entries folded back into stripes
            "flushed_versions": 0,      # versions collapsed across all flushes
            "saved_parity_rounds": 0,   # parity rounds avoided (N-1 per flush)
            "saved_parity_bytes": 0,    # modeled delta-leg bytes avoided
            "evictions": 0,             # capacity-evicted entries (flushed)
            "barrier_flushes": 0,       # read-barrier / failure-driven drains
        }

    def snapshot(self) -> dict:
        return dict(self.stats, buffered_keys=len(self.buffer),
                    tracked_keys=len(self.tracker._score))
