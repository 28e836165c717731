"""Cuckoo-hash indexes (paper §3.2).

Two hash functions map a key to two candidate buckets; each bucket is 4-way
set-associative (4 slots).  Inserts relocate (kick) existing entries on
collision via a bounded random walk; occupancy reaches >90 % (paper cites
[28, 29]).  Both the *object index* (key -> ObjectRef) and the *chunk index*
(chunk ID -> chunk reference) use this structure.

The insert/kick path is host-side (as in the C++ original); the data-plane
batched lookup (`bucket_arrays` + `repro.kernels.cuckoo_lookup`) exposes the
table as flat arrays so GET probes can run on device.
"""
from __future__ import annotations

import numpy as np

SLOTS_PER_BUCKET = 4
MAX_KICKS = 512

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a(data: bytes, seed: int = 0) -> int:
    h = (_FNV_OFFSET ^ seed) & _MASK64
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    # murmur3 fmix64 avalanche: FNV's xor/multiply chain is bit-triangular
    # (low bits never see high bits), which correlates h mod 2^b across
    # seeds — fatal for two-stage hashing.  The finalizer fixes it.
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h


def hash_pair(key: bytes) -> tuple[int, int]:
    """Two independent 64-bit hashes of a key."""
    h1 = fnv1a(key, seed=0)
    h2 = fnv1a(key, seed=0x9E3779B97F4A7C15)
    return h1, h2


class CuckooIndex:
    """4-way set-associative cuckoo hash mapping key-bytes -> python object.

    Stores the full 64-bit fingerprint per slot plus a sidecar dict from
    (bucket, slot) -> (key, value) to resolve fingerprint collisions exactly
    (the C++ original stores object pointers; we keep exactness for tests).
    """

    def __init__(self, num_buckets: int = 1024, rng: np.random.Generator | None = None):
        if num_buckets & (num_buckets - 1):
            raise ValueError("num_buckets must be a power of two")
        self.num_buckets = num_buckets
        self.fingerprints = np.zeros((num_buckets, SLOTS_PER_BUCKET), dtype=np.uint64)
        self.occupied = np.zeros((num_buckets, SLOTS_PER_BUCKET), dtype=bool)
        self.slot_data: dict[tuple[int, int], tuple[bytes, object]] = {}
        self.size = 0
        self._rng = rng or np.random.default_rng(0)
        self.total_kicks = 0

    # -- internals --------------------------------------------------------
    def _buckets_for(self, key: bytes) -> tuple[int, int, int]:
        h1, h2 = hash_pair(key)
        fp = h1 if h1 != 0 else 1  # 0 is the empty sentinel
        return h1 % self.num_buckets, h2 % self.num_buckets, fp

    def _find(self, key: bytes):
        b1, b2, fp = self._buckets_for(key)
        for b in (b1, b2):
            row = self.fingerprints[b]
            for s in range(SLOTS_PER_BUCKET):
                if self.occupied[b, s] and row[s] == fp:
                    k, v = self.slot_data[(b, s)]
                    if k == key:
                        return b, s
        return None

    # -- public API -------------------------------------------------------
    def lookup(self, key: bytes):
        loc = self._find(key)
        if loc is None:
            return None
        return self.slot_data[loc][1]

    def __contains__(self, key: bytes) -> bool:
        return self._find(key) is not None

    def insert(self, key: bytes, value: object) -> bool:
        """Insert or overwrite.  Returns False if the table is too full."""
        loc = self._find(key)
        if loc is not None:
            k, _ = self.slot_data[loc]
            self.slot_data[loc] = (k, value)
            return True
        b1, b2, fp = self._buckets_for(key)
        for b in (b1, b2):
            for s in range(SLOTS_PER_BUCKET):
                if not self.occupied[b, s]:
                    self._place(b, s, fp, key, value)
                    return True
        # Kick path: bounded random walk.
        cur_key, cur_val, cur_fp = key, value, fp
        b = b1 if self._rng.integers(2) else b2
        for _ in range(MAX_KICKS):
            s = int(self._rng.integers(SLOTS_PER_BUCKET))
            vk, vv = self.slot_data[(b, s)]
            vfp = int(self.fingerprints[b, s])
            self._place(b, s, cur_fp, cur_key, cur_val, replacing=True)
            cur_key, cur_val, cur_fp = vk, vv, vfp
            self.total_kicks += 1
            vb1, vb2, _ = self._buckets_for(cur_key)
            b = vb2 if b == vb1 else vb1
            for s2 in range(SLOTS_PER_BUCKET):
                if not self.occupied[b, s2]:
                    self._place(b, s2, cur_fp, cur_key, cur_val)
                    return True
        # Give the displaced key a home back via resize.
        self._resize()
        return self.insert(cur_key, cur_val)

    def _place(self, b, s, fp, key, value, replacing=False):
        if not replacing and self.occupied[b, s]:
            raise RuntimeError("slot occupied")
        if not self.occupied[b, s]:
            self.size += 1
        self.fingerprints[b, s] = np.uint64(fp)
        self.occupied[b, s] = True
        self.slot_data[(b, s)] = (key, value)

    def delete(self, key: bytes) -> bool:
        loc = self._find(key)
        if loc is None:
            return False
        b, s = loc
        self.occupied[b, s] = False
        self.fingerprints[b, s] = 0
        del self.slot_data[(b, s)]
        self.size -= 1
        return True

    def _resize(self):
        old = list(self.slot_data.values())
        self.num_buckets *= 2
        self.fingerprints = np.zeros((self.num_buckets, SLOTS_PER_BUCKET), dtype=np.uint64)
        self.occupied = np.zeros((self.num_buckets, SLOTS_PER_BUCKET), dtype=bool)
        self.slot_data = {}
        self.size = 0
        for k, v in old:
            self.insert(k, v)

    def keys(self) -> list[bytes]:
        """Every stored key (arbitrary order; callers sort for
        determinism).  Used by migration planning to enumerate a server's
        resident objects."""
        return [k for k, _ in self.slot_data.values()]

    @property
    def occupancy(self) -> float:
        return self.size / (self.num_buckets * SLOTS_PER_BUCKET)

    def items(self):
        return list(self.slot_data.values())

    def clear(self):
        self.fingerprints[:] = 0
        self.occupied[:] = False
        self.slot_data.clear()
        self.size = 0

    # -- data-plane export -------------------------------------------------
    def bucket_arrays(self):
        """(fingerprints u64 [B,4], occupied bool [B,4]) for device lookup."""
        return self.fingerprints.copy(), self.occupied.copy()
