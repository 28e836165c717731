"""MemEC proxy (paper §4.1, §5.3): client entry point + request backups.

Each proxy:
* maps keys to servers with two-stage hashing (decentralized, normal mode),
* buffers every request until acknowledged (replayable as degraded
  requests after a failure),
* buffers key->chunk-ID mappings piggybacked on SET acks, flushed when the
  data server checkpoints (§5.3),
* attaches a local sequence number + acked watermark so parity servers can
  prune their delta buffers.
"""
from __future__ import annotations

import dataclasses

from .chunk import ChunkId
from .stripe import StripeList, StripeMapper


@dataclasses.dataclass
class PendingRequest:
    seq: int
    kind: str               # SET/UPDATE/DELETE (GETs are read-only, no backup)
    key: bytes
    value: bytes | None
    stripe_list: StripeList
    data_server: int


class Proxy:
    def __init__(self, pid: int, mapper: StripeMapper):
        self.pid = pid
        self.mapper = mapper
        self.seq = 0
        # mutating requests begun through this proxy (GETs excluded: they
        # carry no backup) — load-distribution introspection for the
        # sharded scatter/gather planner tests
        self.requests_begun = 0
        self.pending: dict[int, PendingRequest] = {}
        self.acked: set[int] = set()
        self.ack_watermark = 0  # all seqs <= watermark are acked
        # key -> chunk-ID mapping backups, per data server (§5.3); the
        # SET ack piggybacks the instance seq so recovery merges across
        # proxies keep the newest instance of a re-SET key
        self.mapping_buffer: dict[int, list[tuple[bytes, ChunkId, int | None]]] = {}

    # -- sequencing ------------------------------------------------------
    def next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def begin(self, kind: str, key: bytes, value: bytes | None,
              sl: StripeList, data_server: int) -> PendingRequest:
        req = PendingRequest(self.next_seq(), kind, key, value, sl, data_server)
        self.pending[req.seq] = req
        self.requests_begun += 1
        return req

    def ack(self, seq: int):
        self.pending.pop(seq, None)
        self.acked.add(seq)
        while (self.ack_watermark + 1) in self.acked:
            self.ack_watermark += 1
            self.acked.discard(self.ack_watermark)

    def unacked_seqs(self) -> set[int]:
        return set(self.pending.keys())

    # -- mapping backups ---------------------------------------------------
    def buffer_mapping(self, server_id: int, key: bytes, cid: ChunkId,
                       iseq: int | None = None):
        self.mapping_buffer.setdefault(server_id, []).append((key, cid, iseq))

    def clear_mappings(self, server_id: int):
        self.mapping_buffer.pop(server_id, None)

    def mappings_for(self, server_id: int) -> list[tuple[bytes, ChunkId, int | None]]:
        return list(self.mapping_buffer.get(server_id, []))
