"""Baseline data models the paper compares against (§3.1, Exp. 1/2).

* All-replication — (n-k+1) full object copies (key, value, metadata,
  reference), as in Memcache/Redis-with-replication/RAMCloud.
* Hybrid-encoding — erasure-code values across objects; replicate key +
  metadata + reference (n-k+1)x, as in LH*RS / Cocytus.

Both expose the MemECCluster request API (set/get/update/delete +
fail/restore) and the same netsim accounting so the Exp. 1/2 benchmarks
compare like for like.  They are deliberately simpler than MemEC: their
point is redundancy + traffic shape, not degraded-mode machinery.
"""
from __future__ import annotations

import numpy as np

from .chunk import CHUNK_SIZE, object_size
from .codes import make_code
from .index import CuckooIndex, fnv1a
from .netsim import CostModel, Leg, NetSim
from .stripe import StripeMapper, generate_stripe_lists


class AllReplicationCluster:
    """(n-k+1)-way replication KV store."""

    def __init__(self, num_servers: int = 16, num_proxies: int = 4,
                 n: int = 10, k: int = 8, c: int = 16,
                 cost: CostModel | None = None):
        self.num_servers = num_servers
        self.replicas = n - k + 1
        self.net = NetSim(cost)
        self.stores = [dict() for _ in range(num_servers)]
        self.indexes = [CuckooIndex(1 << 12) for _ in range(num_servers)]
        self.failed: set[int] = set()
        # reuse stripe lists purely as replica placement groups
        self.lists = generate_stripe_lists(num_servers, n, k, c)
        self.mapper = StripeMapper(self.lists)

    def _replica_set(self, key: bytes) -> list[int]:
        sl, primary = self.mapper.data_server_for(key)
        others = [s for s in sl.servers if s != primary]
        h = fnv1a(key, seed=7)
        picks = [primary]
        i = h % len(others)
        while len(picks) < self.replicas:
            picks.append(others[i % len(others)])
            i += 1
        return picks

    def set(self, key: bytes, value: bytes, proxy_id: int = 0):
        targets = self._replica_set(key)
        nbytes = object_size(len(key), len(value))
        t = self.net.phase([Leg("set", nbytes, f"p{proxy_id}", f"s{s}",
                                s in self.failed) for s in targets])
        for s in targets:
            self.stores[s][key] = value
            self.indexes[s].insert(key, len(value))
        t += self.net.phase([Leg("set_ack", 8, f"s{s}", f"p{proxy_id}",
                                 s in self.failed) for s in targets])
        self.net.record("SET", t)
        return True

    def get(self, key: bytes, proxy_id: int = 0):
        targets = self._replica_set(key)
        # read from the first available replica
        for s in targets:
            if s not in self.failed:
                t = self.net.phase([Leg("get", len(key), f"p{proxy_id}", f"s{s}")])
                v = self.stores[s].get(key)
                t += self.net.phase([Leg("get_resp", len(v) if v else 0,
                                         f"s{s}", f"p{proxy_id}")])
                self.net.record("GET", t)
                return v
        s = targets[0]
        t = self.net.phase([Leg("get", len(key), f"p{proxy_id}", f"s{s}", True)])
        v = self.stores[s].get(key)
        self.net.record("GET", t)
        return v

    def update(self, key: bytes, value: bytes, proxy_id: int = 0):
        targets = self._replica_set(key)
        t = self.net.phase([Leg("update", len(key) + len(value), f"p{proxy_id}",
                                f"s{s}", s in self.failed) for s in targets])
        ok = False
        for s in targets:
            if key in self.stores[s]:
                self.stores[s][key] = value
                ok = True
        t += self.net.phase([Leg("update_ack", 8, f"s{targets[0]}",
                                 f"p{proxy_id}")])
        self.net.record("UPDATE", t)
        return ok

    def delete(self, key: bytes, proxy_id: int = 0):
        targets = self._replica_set(key)
        t = self.net.phase([Leg("delete", len(key), f"p{proxy_id}", f"s{s}",
                                s in self.failed) for s in targets])
        ok = False
        for s in targets:
            ok |= self.stores[s].pop(key, None) is not None
            self.indexes[s].delete(key)
        self.net.record("DELETE", t)
        return ok

    def fail_server(self, sid: int):
        self.failed.add(sid)
        return {"T_N_to_D": 0.0}

    def restore_server(self, sid: int):
        self.failed.discard(sid)
        return {"T_D_to_N": 0.0}

    def total_memory(self) -> dict:
        payload = sum(len(k) + len(v) + 4 for st in self.stores
                      for k, v in st.items())
        refs = sum(ix.num_buckets * 4 * 8 for ix in self.indexes)
        return {"objects": payload, "index": refs}


class HybridEncodingCluster:
    """Cocytus-style: values erasure-coded across objects; keys + metadata +
    references replicated to the data server and all parity servers.

    Value chunks stripe across the k data servers of a stripe list: local
    value-chunk i of each data server position forms stripe (list, i); the
    m parity chunks of that stripe live on the list's parity servers.
    """

    def __init__(self, num_servers: int = 16, num_proxies: int = 4,
                 scheme: str = "rs", n: int = 10, k: int = 8, c: int = 16,
                 chunk_size: int = CHUNK_SIZE, cost: CostModel | None = None):
        self.code = make_code(scheme, n, k)
        self.n, self.k = self.code.n, self.code.k
        self.chunk_size = chunk_size
        self.net = NetSim(cost)
        self.lists = generate_stripe_lists(num_servers, n, k, c)
        self.mapper = StripeMapper(self.lists)
        self.num_servers = num_servers
        # value_chunks[sid][list_id] -> list of 4KB arrays (stripe position
        # of array i is this server's data position in the list; stripe i)
        self.value_chunks: list[dict[int, list[np.ndarray]]] = [
            {} for _ in range(num_servers)]
        self.fill: list[dict[int, int]] = [{} for _ in range(num_servers)]
        self.key_index: list[CuckooIndex] = [CuckooIndex(1 << 12)
                                             for _ in range(num_servers)]
        # (list_id, stripe_idx, parity_row) -> parity chunk
        self.parity_chunks: dict[tuple, np.ndarray] = {}
        self.failed: set[int] = set()
        self.key_meta_bytes = 0  # replicated key+metadata+ref accounting

    def _value_loc(self, sid: int, list_id: int, vsize: int):
        chunks = self.value_chunks[sid].setdefault(list_id, [])
        fill = self.fill[sid].get(list_id, self.chunk_size)
        if fill + vsize > self.chunk_size:
            chunks.append(np.zeros(self.chunk_size, np.uint8))
            fill = 0
        idx = len(chunks) - 1
        self.fill[sid][list_id] = fill + vsize
        return idx, fill

    def _apply_parity_delta(self, sl, dpos: int, idx: int, off: int,
                            xor: np.ndarray):
        full = np.zeros(self.chunk_size, np.uint8)
        full[off: off + len(xor)] = xor
        deltas = self.code.xor_delta(dpos, full)
        for j in range(self.n - self.k):
            pk = (sl.list_id, idx, j)
            if pk not in self.parity_chunks:
                self.parity_chunks[pk] = np.zeros(self.chunk_size, np.uint8)
            self.parity_chunks[pk] ^= deltas[j]

    def set(self, key: bytes, value: bytes, proxy_id: int = 0):
        sl, ds = self.mapper.data_server_for(key)
        vsize = max(len(value), 1)
        idx, off = self._value_loc(ds, sl.list_id, vsize)
        buf = self.value_chunks[ds][sl.list_id][idx]
        buf[off: off + len(value)] = np.frombuffer(value, np.uint8)
        meta = (idx, off, len(value))
        legs = [Leg("set", object_size(len(key), len(value)), f"p{proxy_id}",
                    f"s{ds}", ds in self.failed)]
        self.key_index[ds].insert(key, meta)
        kmr = len(key) + 4 + 8
        self.key_meta_bytes += kmr * (self.n - self.k + 1)
        dpos = sl.data_servers.index(ds)
        self._apply_parity_delta(sl, dpos, idx,
                                 off, np.frombuffer(value, np.uint8))
        for p in sl.parity_servers:
            self.key_index[p].insert(key, meta)
            legs.append(Leg("set_parity", kmr + len(value), f"p{proxy_id}",
                            f"s{p}", p in self.failed))
        t = self.net.phase(legs)
        t += self.net.phase([Leg("set_ack", 8, f"s{ds}", f"p{proxy_id}",
                                 ds in self.failed)])
        self.net.record("SET", t)
        return True

    def get(self, key: bytes, proxy_id: int = 0):
        sl, ds = self.mapper.data_server_for(key)
        if ds not in self.failed:
            t = self.net.phase([Leg("get", len(key), f"p{proxy_id}", f"s{ds}")])
            meta = self.key_index[ds].lookup(key)
            if meta is None:
                self.net.record("GET", t)
                return None
            idx, off, vlen = meta
            v = self.value_chunks[ds][sl.list_id][idx][off: off + vlen].tobytes()
            t += self.net.phase([Leg("get_resp", vlen, f"s{ds}", f"p{proxy_id}")])
            self.net.record("GET", t)
            return v
        # degraded read: decode the failed server's value chunk
        meta = None
        probe = None
        for p in sl.parity_servers:
            if p not in self.failed:
                probe = p
                meta = self.key_index[p].lookup(key)
                break
        if meta is None:
            self.net.record("GET_DEG", 0.0)
            return None
        idx, off, vlen = meta
        dpos = sl.data_servers.index(ds)
        available = {}
        legs = []
        for i, s in enumerate(sl.data_servers):
            if s in self.failed or i == dpos:
                continue
            chunks = self.value_chunks[s].get(sl.list_id, [])
            available[i] = (chunks[idx] if idx < len(chunks)
                            else np.zeros(self.chunk_size, np.uint8))
            legs.append(Leg("recon_fetch", self.chunk_size, f"s{s}", f"s{probe}"))
        for j in range(self.n - self.k):
            s = sl.parity_servers[j]
            if s in self.failed:
                continue
            pk = (sl.list_id, idx, j)
            available[self.k + j] = self.parity_chunks.get(
                pk, np.zeros(self.chunk_size, np.uint8))
            legs.append(Leg("recon_fetch", self.chunk_size, f"s{s}", f"s{probe}"))
        t = self.net.phase(legs[: self.k])
        rec = self.code.decode(available, [dpos], self.chunk_size)[dpos]
        v = rec[off: off + vlen].tobytes()
        t += self.net.phase([Leg("get_resp", vlen, f"s{probe}", f"p{proxy_id}")])
        self.net.record("GET_DEG", t)
        return v

    def update(self, key: bytes, value: bytes, proxy_id: int = 0):
        sl, ds = self.mapper.data_server_for(key)
        meta = self.key_index[ds].lookup(key) if ds not in self.failed else None
        if meta is None:
            self.net.record("UPDATE", 0.0)
            return False
        idx, off, vlen = meta
        if len(value) != vlen:
            raise ValueError("value size fixed across updates")
        buf = self.value_chunks[ds][sl.list_id][idx]
        old = buf[off: off + vlen].copy()
        buf[off: off + vlen] = np.frombuffer(value, np.uint8)
        xor = old ^ buf[off: off + vlen]
        dpos = sl.data_servers.index(ds)
        self._apply_parity_delta(sl, dpos, idx, off, xor)
        legs = [Leg("update", len(key) + vlen, f"p{proxy_id}", f"s{ds}")]
        legs += [Leg("delta", vlen, f"s{ds}", f"s{p}", p in self.failed)
                 for p in sl.parity_servers]
        t = self.net.phase(legs)
        t += self.net.phase([Leg("update_ack", 8, f"s{ds}", f"p{proxy_id}")])
        self.net.record("UPDATE", t)
        return True

    def delete(self, key: bytes, proxy_id: int = 0):
        sl, ds = self.mapper.data_server_for(key)
        meta = self.key_index[ds].lookup(key)
        if meta is None:
            return False
        idx, off, vlen = meta
        self.update(key, b"\x00" * vlen, proxy_id)
        for s in [ds] + list(sl.parity_servers):
            self.key_index[s].delete(key)
        return True

    def fail_server(self, sid: int):
        self.failed.add(sid)
        return {"T_N_to_D": 0.0}

    def restore_server(self, sid: int):
        self.failed.discard(sid)
        return {"T_D_to_N": 0.0}

    def total_memory(self) -> dict:
        chunks = sum(len(cs) for d in self.value_chunks
                     for cs in d.values()) * self.chunk_size
        parity = len(self.parity_chunks) * self.chunk_size
        refs = sum(ix.num_buckets * 4 * 8 for ix in self.key_index)
        return {"value_chunks": chunks, "parity_chunks": parity,
                "replicated_keys_meta": self.key_meta_bytes, "index": refs}
