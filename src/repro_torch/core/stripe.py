"""Stripe-list generation and two-stage hashing (paper §4.3).

A *stripe list* names the k data servers and n-k parity servers of a stripe.
Because every data write fans out to all n-k parity servers, a parity server
absorbs k× the write load of a data server; the generator below greedily
balances aggregate write load: per iteration pick the n-k least-loaded
servers as parity (+k load each) and the next k as data (+1 load each).

Proxies map a key to a server with two-stage hashing:
    key -> stripe list (hash % c) -> data server within the list.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .index import fnv1a


@dataclasses.dataclass(frozen=True)
class StripeList:
    list_id: int
    data_servers: tuple[int, ...]    # k server ids
    parity_servers: tuple[int, ...]  # n-k server ids

    @property
    def servers(self) -> tuple[int, ...]:
        return self.data_servers + self.parity_servers

    @property
    def n(self) -> int:
        return len(self.servers)

    @property
    def k(self) -> int:
        return len(self.data_servers)

    def position_of(self, server_id: int) -> int:
        return self.servers.index(server_id)


def generate_stripe_lists(num_servers: int, n: int, k: int, c: int) -> list[StripeList]:
    """Greedy write-load-balanced stripe-list generation (paper §4.3)."""
    if num_servers < n:
        raise ValueError(f"need >= n={n} servers, got {num_servers}")
    load = np.zeros(num_servers, dtype=np.int64)
    out: list[StripeList] = []
    for i in range(c):
        # stable sort by (load, server id) — ties broken by smaller id
        order = np.lexsort((np.arange(num_servers), load))
        parity = tuple(int(s) for s in order[: n - k])
        data = tuple(int(s) for s in order[n - k: n])
        for s in parity:
            load[s] += k
        for s in data:
            load[s] += 1
        out.append(StripeList(list_id=i, data_servers=data, parity_servers=parity))
    return out


def write_loads(lists: list[StripeList], num_servers: int) -> np.ndarray:
    load = np.zeros(num_servers, dtype=np.int64)
    for sl in lists:
        for s in sl.parity_servers:
            load[s] += sl.k
        for s in sl.data_servers:
            load[s] += 1
    return load


class StripeMapper:
    """Two-stage hashing used by proxies in normal mode (decentralized)."""

    def __init__(self, lists: list[StripeList]):
        self.lists = lists

    def stripe_list_for(self, key: bytes) -> StripeList:
        h = fnv1a(key, seed=0x5BD1E995)
        return self.lists[h % len(self.lists)]

    def data_server_for(self, key: bytes) -> tuple[StripeList, int]:
        sl = self.stripe_list_for(key)
        h = fnv1a(key, seed=0xC2B2AE3D)
        ds = sl.data_servers[h % len(sl.data_servers)]
        return sl, ds
