"""MemEC coordinator (paper §4.1, §5.2): server states + transitions.

The coordinator is outside the I/O path in normal mode.  On failure it
drives the state machine of Figure 4:

    NORMAL -> INTERMEDIATE -> DEGRADED -> COORDINATED_NORMAL -> NORMAL

broadcasting each state change atomically to all proxies and working
servers (the Spread toolkit in the prototype; a synchronous broadcast in
this simulation — strictly stronger ordering).  It also stores the periodic
key->chunk-ID mapping checkpoints (§5.3) and picks redirected servers for
degraded requests (§5.4).
"""
from __future__ import annotations

import enum
from collections import defaultdict

from .chunk import ChunkId
from .stripe import StripeList


class ServerState(enum.Enum):
    NORMAL = "normal"
    INTERMEDIATE = "intermediate"
    DEGRADED = "degraded"
    COORDINATED_NORMAL = "coordinated_normal"


class Coordinator:
    def __init__(self, num_servers: int, stripe_lists: list[StripeList],
                 shard_id: int | None = None):
        self.num_servers = num_servers
        self.stripe_lists = stripe_lists
        self.shard_id = shard_id  # None for the unsharded cluster
        self.states: dict[int, ServerState] = {
            s: ServerState.NORMAL for s in range(num_servers)}
        # key -> (chunk-ID, instance seq) mapping checkpoints, per server
        # (§5.3); the instance seq orders re-SETs of the same key so the
        # recovery merge below can never resurrect a superseded mapping
        self.mapping_ckpt: dict[int, dict[bytes, tuple[ChunkId, int | None]]] = \
            defaultdict(dict)
        # merged (checkpoint + proxy buffers) view built at failure time
        self.recovery_mappings: dict[int, dict[bytes, tuple[ChunkId, int | None]]] = {}
        # (state name, server, shard, logical step) — deterministic audit
        # trail for the transition tests; no wall clock on purpose
        self.transition_log: list[tuple[str, int, int | None, int]] = []
        self._step = 0
        # sticky degraded-routing choices: (failed sid, list id) -> server.
        # Without stickiness, restoring an unrelated server could silently
        # re-rank `redirected_server` and strand degraded state (temp
        # objects, reconstructed chunks) at the previous target.
        self.redirect_assignments: dict[tuple[int, int], int] = {}

    # -- state machine -----------------------------------------------------
    def state_of(self, sid: int) -> ServerState:
        return self.states[sid]

    def failed_servers(self) -> list[int]:
        return [s for s, st in self.states.items()
                if st in (ServerState.INTERMEDIATE, ServerState.DEGRADED)]

    def is_available(self, sid: int) -> bool:
        return self.states[sid] == ServerState.NORMAL or \
            self.states[sid] == ServerState.COORDINATED_NORMAL

    def set_state(self, sid: int, state: ServerState):
        self.states[sid] = state
        self._step += 1
        self.transition_log.append((state.value, sid, self.shard_id,
                                    self._step))

    def any_failure(self) -> bool:
        return any(st != ServerState.NORMAL for st in self.states.values())

    # -- mapping checkpoints -------------------------------------------------
    @staticmethod
    def _newer(cur: tuple[ChunkId, int | None] | None,
               iseq: int | None) -> bool:
        """Does a mapping with instance seq ``iseq`` supersede ``cur``?
        Unversioned entries (None) never beat a versioned one."""
        if cur is None:
            return True
        cur_iseq = cur[1]
        if cur_iseq is None:
            return True
        return iseq is not None and iseq >= cur_iseq

    def store_checkpoint(self, sid: int,
                         mappings: list[tuple[bytes, ChunkId, int | None]]):
        d = self.mapping_ckpt[sid]
        for key, cid, iseq in mappings:
            if self._newer(d.get(key), iseq):
                d[key] = (cid, iseq)

    def merge_proxy_mappings(self, sid: int,
                             proxy_maps: list[list[tuple[bytes, ChunkId, int | None]]]):
        """Merge checkpointed + proxy-buffered mappings at failure time.
        Different proxies may buffer mappings for *different instances*
        of the same re-SET key; the instance seq, not merge order,
        decides which chunk the degraded path should resolve to."""
        merged = dict(self.mapping_ckpt.get(sid, {}))
        for pm in proxy_maps:
            for key, cid, iseq in pm:
                if self._newer(merged.get(key), iseq):
                    merged[key] = (cid, iseq)
        self.recovery_mappings[sid] = merged

    def chunk_id_for(self, sid: int, key: bytes) -> ChunkId | None:
        ent = self.recovery_mappings.get(sid, {}).get(key)
        return ent[0] if ent is not None else None

    # -- degraded routing (§5.4) ---------------------------------------------
    def redirected_server(self, sl: StripeList, failed_sid: int) -> int:
        """Sticky, deterministic choice of a working server in the list.

        The first call for a (failed server, stripe list) pair picks the
        first available server and records it; later calls return the same
        target while it stays available, so degraded state accumulated
        there remains reachable even as *other* servers fail or recover.
        A target that itself fails triggers a reassignment (the cluster
        hands its redirect state off, see ``MemECCluster.fail_server``).
        """
        akey = (failed_sid, sl.list_id)
        cur = self.redirect_assignments.get(akey)
        if cur is not None and self.is_available(cur):
            return cur
        for s in sl.servers:
            if s != failed_sid and self.is_available(s):
                self.redirect_assignments[akey] = s
                return s
        raise RuntimeError("no working server available in stripe list")

    def clear_redirects(self, restored_sid: int):
        """Drop sticky assignments for a server that came back (§5.5)."""
        for akey in [a for a in self.redirect_assignments
                     if a[0] == restored_sid]:
            del self.redirect_assignments[akey]
