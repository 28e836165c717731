"""YCSB-style workload generator (paper §7 evaluation setup).

Workloads A/B/C/D/F with the paper's request mixes; keys are drawn from a
heavy-tailed Zipf(0.99) distribution over a preloaded object population,
matching §7: 24-byte keys; half the objects 8-byte values, half 32-byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np

WORKLOADS = {
    # proportions of (GET, UPDATE, SET, RMW)
    "load": {"set": 1.0},
    "A": {"get": 0.5, "update": 0.5},
    "B": {"get": 0.95, "update": 0.05},
    "C": {"get": 1.0},
    "D": {"get": 0.95, "set": 0.05},
    "F": {"get": 0.5, "rmw": 0.5},
    # update-heavy (the MemEC evaluation's write-side axis; drives the
    # hot-key version-buffer tier in benchmarks/throughput.py)
    "U": {"get": 0.05, "update": 0.95},
}


@dataclasses.dataclass
class YCSBConfig:
    num_objects: int = 10000
    key_size: int = 24
    value_sizes: tuple = (8, 32)
    zipf_theta: float = 0.99
    seed: int = 42


class ZipfGenerator:
    """Classic YCSB zeta-based Zipfian over [0, n)."""

    def __init__(self, n: int, theta: float, rng: np.random.Generator):
        self.n = n
        self.theta = theta
        self.rng = rng
        self.zetan = np.sum(1.0 / np.power(np.arange(1, n + 1), theta))
        self.alpha = 1.0 / (1.0 - theta)
        zeta2 = np.sum(1.0 / np.power(np.arange(1, 3), theta))
        self.eta = (1 - (2.0 / n) ** (1 - theta)) / (1 - zeta2 / self.zetan)

    def sample(self, size: int) -> np.ndarray:
        u = self.rng.random(size)
        uz = u * self.zetan
        out = np.empty(size, dtype=np.int64)
        cut1 = uz < 1.0
        cut2 = (~cut1) & (uz < 1.0 + 0.5 ** self.theta)
        out[cut1] = 0
        out[cut2] = 1
        rest = ~(cut1 | cut2)
        out[rest] = (self.n * np.power(self.eta * u[rest] - self.eta + 1,
                                       self.alpha)).astype(np.int64)
        return np.clip(out, 0, self.n - 1)


class YCSBWorkload:
    def __init__(self, cfg: YCSBConfig, id_map: np.ndarray | None = None):
        """``id_map`` (optional): permutation of object ids applied to the
        Zipf samples — the skewed-workload axis.  Rank r of the Zipf
        distribution hits object ``id_map[r]``, so a map that front-loads
        one shard's objects (see ``hot_shard_id_map``) concentrates the
        hot tail on that shard."""
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.zipf = ZipfGenerator(cfg.num_objects, cfg.zipf_theta, self.rng)
        self.inserted = cfg.num_objects  # next insert id (workload D)
        self.id_map = id_map

    def key(self, i: int) -> bytes:
        return b"user%019d" % i  # 24 bytes, YCSB-style

    def _map_id(self, i: int) -> int:
        if self.id_map is not None and i < len(self.id_map):
            return int(self.id_map[i])
        return i

    def value_size(self, i: int) -> int:
        return self.cfg.value_sizes[i % len(self.cfg.value_sizes)]

    def value(self, i: int, version: int = 0) -> bytes:
        rng = np.random.default_rng(i * 7919 + version)
        return rng.bytes(self.value_size(i))

    def load_ops(self):
        """The load phase: SET every object once."""
        for i in range(self.cfg.num_objects):
            yield ("set", self.key(i), self.value(i))

    def run_ops(self, workload: str, num_ops: int):
        mix = WORKLOADS[workload]
        kinds = list(mix.keys())
        probs = np.array([mix[k] for k in kinds])
        choices = self.rng.choice(len(kinds), size=num_ops, p=probs)
        ids = self.zipf.sample(num_ops)
        for t in range(num_ops):
            kind = kinds[choices[t]]
            i = self._map_id(int(ids[t]))
            if kind == "get":
                yield ("get", self.key(i), None)
            elif kind == "update":
                yield ("update", self.key(i), self.value(i, version=t))
            elif kind == "set":
                i = self.inserted
                self.inserted += 1
                yield ("set", self.key(i), self.value(i))
            elif kind == "rmw":
                yield ("get", self.key(i), None)
                yield ("update", self.key(i), self.value(i, version=t))


def hot_shard_id_map(cluster, cfg: YCSBConfig, hot_shard: int) -> np.ndarray:
    """Skewed-workload axis: a permutation of object ids that parks the
    Zipf-hottest ranks on ``hot_shard``'s keys, turning key-popularity
    skew into *shard* skew (the scenario ``ShardedCluster.rebalance``
    escapes).  Objects resident on ``hot_shard`` take the low (hot) Zipf
    ranks in id order; everything else follows."""
    w = YCSBWorkload(cfg)
    hot, cold = [], []
    for i in range(cfg.num_objects):
        (hot if cluster.shard_of(w.key(i)) == hot_shard else cold).append(i)
    return np.array(hot + cold, dtype=np.int64)


def run_workload(cluster, workload: str, num_ops: int,
                 cfg: YCSBConfig | None = None, num_proxies: int = 4,
                 batch_size: int = 1, hot_shard: int | None = None,
                 id_map: np.ndarray | None = None):
    """Drive a cluster through a workload; returns the op count executed.

    ``batch_size > 1`` collects a *window* of up to ``batch_size`` ops —
    mixed kinds allowed — and flushes it as per-kind multi-key requests
    (``multi_get``/``multi_set``/``multi_update``), amortizing coding and
    network legs (and, on a sharded cluster, pipelining across shards).
    A window is flushed early whenever an incoming op touches a key the
    window already holds under a conflicting kind, so the per-key
    read/write order — and therefore the final store state — matches
    sequential execution exactly.

    ``hot_shard`` (sharded clusters only) engages the skewed-workload
    axis: Zipf-hot ranks are remapped onto that shard's resident objects
    (``hot_shard_id_map``), producing the hot-shard scenario the
    rebalance benchmark and tests measure.  Pass a precomputed ``id_map``
    instead to keep the *same* hot key set across placement changes
    (hot keys are a property of the traffic, not of the placement).
    """
    cfg = cfg or YCSBConfig()
    if id_map is None and hot_shard is not None:
        id_map = hot_shard_id_map(cluster, cfg, hot_shard)
    w = YCSBWorkload(cfg, id_map=id_map)
    stream = (w.load_ops() if workload == "load"
              else w.run_ops(workload, num_ops))
    avail_proxies = getattr(cluster, "num_proxies", None)
    if avail_proxies:   # never address proxies the cluster doesn't have
        num_proxies = min(num_proxies, avail_proxies)
    ops = 0
    batched = batch_size > 1 and hasattr(cluster, "multi_set")
    if not batched:
        for t, (kind, key, val) in enumerate(stream):
            pid = t % num_proxies
            if kind == "get":
                cluster.get(key, proxy_id=pid)
            elif kind == "update":
                cluster.update(key, val, proxy_id=pid)
            elif kind == "set":
                cluster.set(key, val, proxy_id=pid)
            ops += 1
        return ops, w

    window: list[tuple] = []          # (kind, key, val) in arrival order
    in_window: dict[bytes, str] = {}  # key -> kind currently buffered
    flushes = 0
    # async pipeline: hand the whole window to the store and let it
    # spread per-key-hash lanes across its proxies (proxy_id=None) —
    # concurrent lanes instead of one proxy per flush
    spread = bool(getattr(cluster, "async_engine", False)) and num_proxies > 1

    def flush():
        nonlocal window, in_window, flushes
        if not window:
            return
        pid = None if spread else flushes % num_proxies
        flushes += 1
        by_kind: dict[str, list] = {}
        for kind, key, val in window:   # kinds keep first-arrival order
            by_kind.setdefault(kind, []).append((key, val))
        for kind, items in by_kind.items():
            if kind == "get":
                cluster.multi_get([k for k, _ in items], proxy_id=pid)
            elif kind == "set":
                cluster.multi_set(items, proxy_id=pid)
            elif kind == "update":
                cluster.multi_update(items, proxy_id=pid)
        window = []
        in_window = {}

    for kind, key, val in stream:
        # same-kind repeats of a key are safe inside one multi_* call
        # (the batched paths defer duplicates in order); a kind *switch*
        # on a buffered key would reorder a read against a write
        prev = in_window.get(key)
        if (prev is not None and prev != kind) or len(window) >= batch_size:
            flush()
        window.append((kind, key, val))
        in_window[key] = kind
        ops += 1
    flush()
    return ops, w
