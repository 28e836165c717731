"""Elastic fleet runtime: heartbeats, server states, straggler mitigation.

The paper's coordinator state machine (§5.2) lifted to the training
fleet: hosts heartbeat; misses drive NORMAL -> INTERMEDIATE -> DEGRADED;
a restored host passes through COORDINATED_NORMAL while state migrates
back (here: EC reconstruction of its shard pages).  Stragglers (the
transient-failure model of §7.2 — slow, not dead) are detected by an
EWMA step-time threshold and handled by the same degraded transition
*before* they stall the collective — on a synchronous TPU fleet a
straggler delays every step, so eviction-and-reconstruct beats waiting
once expected delay exceeds reconstruction cost.

This module is pure control-plane logic (deterministic, simulated clock
in tests); the data plane it drives is `ecstore.reconstruct` + a mesh
rebuild excluding the failed host.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from ..core.coordinator import ServerState


@dataclasses.dataclass
class HostInfo:
    host_id: int
    state: ServerState = ServerState.NORMAL
    last_heartbeat: float = 0.0
    step_time_ewma: float = 0.0
    missed: int = 0


@dataclasses.dataclass
class ElasticConfig:
    heartbeat_interval: float = 1.0
    miss_threshold: int = 3
    straggler_factor: float = 2.5     # x median step time
    ewma_alpha: float = 0.2
    min_hosts: int = 2


@dataclasses.dataclass
class RecoveryPlan:
    kind: str                 # "reconstruct" | "rescale" | "none"
    failed_hosts: list
    new_host_count: int
    notes: str = ""


class FleetMonitor:
    def __init__(self, num_hosts: int, cfg: ElasticConfig | None = None):
        self.cfg = cfg or ElasticConfig()
        self.hosts = {h: HostInfo(h) for h in range(num_hosts)}
        self.transitions: list[tuple[float, int, ServerState]] = []

    # -- signals ---------------------------------------------------------
    def heartbeat(self, host: int, now: float):
        hi = self.hosts[host]
        hi.last_heartbeat = now
        hi.missed = 0
        if hi.state == ServerState.INTERMEDIATE:
            # flapped back before the degraded switch completed
            self._set(host, ServerState.NORMAL, now)

    def report_step_time(self, host: int, step_time: float):
        hi = self.hosts[host]
        a = self.cfg.ewma_alpha
        hi.step_time_ewma = (step_time if hi.step_time_ewma == 0
                             else a * step_time + (1 - a) * hi.step_time_ewma)

    # -- evaluation ---------------------------------------------------------
    def _set(self, host: int, state: ServerState, now: float):
        self.hosts[host].state = state
        self.transitions.append((now, host, state))

    def check(self, now: float) -> RecoveryPlan:
        cfg = self.cfg
        # 1. heartbeat misses
        for hi in self.hosts.values():
            if hi.state in (ServerState.NORMAL, ServerState.COORDINATED_NORMAL):
                misses = int((now - hi.last_heartbeat) / cfg.heartbeat_interval)
                if misses >= cfg.miss_threshold:
                    self._set(hi.host_id, ServerState.INTERMEDIATE, now)
        # 2. stragglers: EWMA vs fleet median
        ewmas = sorted(h.step_time_ewma for h in self.hosts.values()
                       if h.step_time_ewma > 0
                       and h.state == ServerState.NORMAL)
        if ewmas:
            med = ewmas[len(ewmas) // 2]
            for hi in self.hosts.values():
                if (hi.state == ServerState.NORMAL and hi.step_time_ewma
                        > cfg.straggler_factor * max(med, 1e-9)):
                    self._set(hi.host_id, ServerState.INTERMEDIATE, now)
        # 3. resolve INTERMEDIATE -> DEGRADED (inconsistency resolution is
        # instantaneous here: the synchronous step either committed or not)
        failed = []
        for hi in self.hosts.values():
            if hi.state == ServerState.INTERMEDIATE:
                self._set(hi.host_id, ServerState.DEGRADED, now)
            if hi.state == ServerState.DEGRADED:
                failed.append(hi.host_id)
        alive = len(self.hosts) - len(failed)
        if not failed:
            return RecoveryPlan("none", [], alive)
        if alive < self.cfg.min_hosts:
            return RecoveryPlan("rescale", failed, alive,
                                notes="below min_hosts; full restore from "
                                      "disk checkpoint required")
        return RecoveryPlan("reconstruct", failed, alive,
                            notes="EC decode-from-k of failed shards, then "
                                  "rescale mesh")

    # -- restore ------------------------------------------------------------
    def restore(self, host: int, now: float):
        self._set(host, ServerState.COORDINATED_NORMAL, now)

    def migration_done(self, host: int, now: float):
        self._set(host, ServerState.NORMAL, now)

    def states(self) -> dict:
        return {h: hi.state for h, hi in self.hosts.items()}
