"""Live stripe migration + skew-aware rebalancing for the sharded cluster.

The ``Rebalancer`` turns a placement change (shard added/removed, ring
weights shifted) into a *minimal-movement* migration plan — only keys
whose placement no longer matches their resident shard move — and then
executes it **live**:

* sealed objects move chunk-wise: each distinct source chunk is fetched
  once (one ``mig_chunk`` leg, accounted on the facade netsim), its
  moving objects are extracted from the authoritative chunk bytes, and
  the destination shard ingests them through the batched
  ``multi_set`` -> ``CodingEngine`` seal path;
* unsealed objects drain individually via redirect-style forwarding: the
  facade's pending-key table keeps routing every GET/SET/UPDATE/DELETE to
  whichever shard currently holds the bytes, so requests keep succeeding
  mid-migration;
* migration overlapping a ``fail_server`` falls back to the shard's
  batched-decode recovery: a failed source server's chunks are read from
  the redirected server's reconstruction cache (warmed by the one-shot
  batched decode in ``fail_server``), or decoded on demand through the
  same engine path;
* the source copy is physically drained (deleted, with parity deltas)
  after the destination acknowledges, so a later membership change can
  never resurrect a stale copy.

Between batches the executor invokes ``step_cb`` so callers (tests, the
rebalance benchmark, the verify.sh smoke) can interleave client traffic
and fault injection with the migration — the "no key is ever unreadable
mid-rebalance" property is exercised there.

Skew-aware rebalancing (``ShardedCluster.rebalance``) watches the
per-shard load counters the facade keeps (max/mean shard ops — the same
metric ``stats()``/``snapshot()`` expose) and, when the skew crosses a
threshold, shifts ring weights inversely to load before planning the
migration, so a Zipf hot shard sheds arcs to its underloaded peers.
"""
from __future__ import annotations

import dataclasses
import struct

from .chunk import fragment_count, object_size
from .netsim import Leg
from .store import LARGE_MAGIC, large_total

# migration leg kinds (facade netsim): one chunk fetch per distinct source
# chunk, one object transfer per moved object
MIG_CHUNK = "mig_chunk"
MIG_OBJ = "mig_obj"


@dataclasses.dataclass
class MigrationPlan:
    """Minimal-movement plan: every (key, src, dst) whose placement
    changed, capped at ``max_moves`` (excess stays forwarded via the
    pending table until a later rebalance)."""
    moves: list[tuple[bytes, int, int]]
    mismatched: int          # residents off-placement (incl. beyond the cap)
    residents: int           # logical residents scanned (fragments excluded)
    est_bytes: int           # object bytes the capped plan will move

    @property
    def move_fraction(self) -> float:
        return self.mismatched / self.residents if self.residents else 0.0


class Rebalancer:
    def __init__(self, cluster, batch_size: int = 64):
        self.cluster = cluster
        self.batch_size = max(1, batch_size)

    # ------------------------------------------------------------------
    # reading resident objects without client-request accounting
    # ------------------------------------------------------------------
    def _read(self, si: int, key: bytes):
        """Authoritative read of a mover for the actual transfer.

        Returns ``(value|None, chunk_token|None, extra_modeled_s)`` where
        ``chunk_token`` identifies the sealed source chunk the value came
        out of (each distinct token is fetched — and charged — once per
        migration).  Plain (non-decoding) resolution is the shard's
        ``peek_value``; the extra work here is chunk attribution plus the
        on-demand batched-decode fallback when a failed source server's
        chunk is not in the reconstruction cache yet.
        """
        sh = self.cluster.shards[si]
        sl, ds = sh.mapper.data_server_for(key)
        if sh._is_failed(ds) and sh._degraded_active(ds):
            value = sh.peek_value(key)
            if value is not None:
                cid = sh.coordinator.chunk_id_for(ds, key)
                rc = (sh._rs(sh.coordinator.redirected_server(sl, ds))
                      .recon.get(cid.key()) if cid is not None else None)
                if rc is not None and rc.value_of(key) == value:
                    r = sh.coordinator.redirected_server(sl, ds)
                    return value, ("recon", si, r, cid.key()), 0.0
                return value, None, 0.0   # shadowed object / replica
            # not peekable: a sealed chunk of the lost server that is not
            # reconstructed yet — batched-decode fallback through the
            # engine (normally fail_server pre-decoded the inventory)
            cid = sh.coordinator.chunk_id_for(ds, key)
            if cid is None:
                return None, None, 0.0
            r = sh.coordinator.redirected_server(sl, ds)
            rc, t_rec = sh._ensure_recon(sl, ds, cid.position,
                                         cid.stripe_id, r)
            return rc.value_of(key), ("recon", si, r, cid.key()), t_rec
        srv = sh.servers[ds]
        ref = srv.lookup(key)
        if ref is None:
            return None, None, 0.0
        value = srv.get_value(key)
        if srv.sealed[ref.chunk_local_idx]:
            return value, ("chunk", si, ds, ref.chunk_local_idx), 0.0
        return value, None, 0.0

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def plan(self, max_moves: int | None = None) -> MigrationPlan:
        """Scan every shard store's resident keys, collect the ones whose
        placement no longer matches, and install the forwarding table
        (``cluster._pending``) that keeps *all* mismatched keys routed to
        their current bytes — including any beyond the ``max_moves`` cap.
        """
        cl = self.cluster
        movers: list[tuple[bytes, int, int]] = []
        pending: dict[bytes, int] = {}
        sizes: dict[bytes, int] = {}
        residents = 0
        for si, sh in enumerate(cl.shards):
            keys = sh.resident_keys()
            keyset = set(keys)
            # large objects move logically: their per-fragment keys are
            # internal to the owning shard and must never migrate alone.
            # Fragments are found structurally — a key whose 4-byte-suffix
            # -stripped parent is also resident AND reads as a manifest —
            # so plan time only ever peeks candidate parents, never the
            # whole data set.
            frag_skip: set[bytes] = set()
            for key in keys:
                if len(key) <= 4:
                    continue
                parent = key[:-4]
                if parent not in keyset or parent in sizes:
                    continue
                total = large_total(sh.peek_value(parent))
                if total is None:
                    continue
                sizes[parent] = total
                nfrag = fragment_count(total, len(parent), cl.chunk_size)
                for fi in range(nfrag):
                    frag_skip.add(parent + struct.pack("<I", fi))
            for key in keys:
                if key in frag_skip:
                    continue
                residents += 1
                dst = cl.placement.shard_for(key)
                if dst != si:
                    pending[key] = si
                    movers.append((key, si, dst))
        mismatched = len(movers)
        if max_moves is not None and mismatched > max_moves:
            # cap pressure goes to the hottest source shards first
            load = cl.shard_ops
            movers.sort(key=lambda m: -load[m[1]] if m[1] < len(load) else 0)
            movers = movers[:max_moves]
        cl._pending.clear()
        cl._pending.update(pending)
        est = 0
        for key, si, _ in movers:   # size only what the capped plan moves
            if key not in sizes:
                head = cl.shards[si].peek_value(key)
                sizes[key] = len(head) if head is not None else 0
            est += object_size(len(key), sizes[key])
        return MigrationPlan(moves=movers, mismatched=mismatched,
                             residents=residents, est_bytes=est)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute(self, plan: MigrationPlan, step_cb=None) -> dict:
        """Move the planned keys in batches; live traffic may interleave
        at every ``step_cb`` boundary (called after each batch)."""
        cl = self.cluster
        moved_keys = moved_bytes = chunk_bytes = skipped = 0
        chunks_seen: set[tuple] = set()
        t_total = 0.0
        nbatches = 0
        for start in range(0, len(plan.moves), self.batch_size):
            batch = plan.moves[start: start + self.batch_size]
            legs: list[Leg] = []
            per_dst: dict[int, list[tuple[bytes, bytes]]] = {}
            large: list[tuple[bytes, int, int, bytes]] = []
            drains: list[tuple[int, bytes]] = []
            t_extra = 0.0

            def charge_chunk(token):
                nonlocal chunk_bytes
                if token is None or token in chunks_seen:
                    return
                chunks_seen.add(token)
                src_ep = f"sh{token[1]}:s{token[2]}"
                legs.append(Leg(MIG_CHUNK, cl.chunk_size, src_ep, "mig"))
                chunk_bytes += cl.chunk_size

            for key, si, di in batch:
                value, token, t_rec = self._read(si, key)
                t_extra += t_rec
                if value is None:
                    # deleted (or lost) since planning — nothing to move;
                    # routing falls through to the new placement
                    cl._pending.pop(key, None)
                    skipped += 1
                    continue
                total = large_total(value)
                if total is not None:
                    parts = []
                    nfrag = fragment_count(total, len(key), cl.chunk_size)
                    for fi in range(nfrag):
                        fval, ftok, t_rec2 = self._read(
                            si, key + struct.pack("<I", fi))
                        t_extra += t_rec2
                        if fval is None:
                            break
                        charge_chunk(ftok)
                        parts.append(fval)
                    if len(parts) < nfrag:
                        # a fragment is unreadable right now: moving a
                        # truncated object and draining the source would
                        # be silent corruption — leave the key forwarded
                        # (still pending) for a later pass instead
                        skipped += 1
                        continue
                    charge_chunk(token)
                    full = b"".join(parts)[:total]
                    large.append((key, si, di, full))
                    nbytes = object_size(len(key), len(full))
                else:
                    charge_chunk(token)
                    per_dst.setdefault(di, []).append((key, value))
                    nbytes = object_size(len(key), len(value))
                legs.append(Leg(MIG_OBJ, nbytes, "mig", f"sh{di}:p0"))
                moved_bytes += nbytes
                drains.append((si, key))
            # migration transfer time: bulk, link-serialized per endpoint
            t = cl.net.local.serialized_phase(legs) + t_extra
            # destination ingest through the batched engine/seal path
            for di, items in sorted(per_dst.items()):
                cl.shards[di].multi_set(items)
            for key, si, di, full in large:
                cl.shards[di].set(key, full)
            # flip routing to the destination, then drain the source copy
            for si, key in drains:
                cl._pending.pop(key, None)
            for si, key in drains:
                cl.shards[si].delete(key)
            moved_keys += len(drains)
            if legs or t_extra:
                cl.net.record("MIGRATE", t)
                t_total += t
            nbatches += 1
            if step_cb is not None:
                step_cb({"batch": nbatches, "moved_keys": moved_keys,
                         "planned": len(plan.moves)})
        cl._stats["migrations"] += 1
        cl._stats["migrated_keys"] += moved_keys
        cl._stats["migration_bytes"] += moved_bytes
        cl._stats["migration_chunk_bytes"] += chunk_bytes
        return {
            "moved_keys": moved_keys,
            "moved_bytes": moved_bytes,
            "chunk_fetch_bytes": chunk_bytes,
            "chunks_fetched": len(chunks_seen),
            "skipped_missing": skipped,
            "batches": nbatches,
            "mismatched": plan.mismatched,
            "residents": plan.residents,
            "move_fraction": plan.move_fraction,
            "pending_left": len(cl._pending),
            "t_modeled_s": t_total,
        }

    def run(self, max_moves: int | None = None, step_cb=None) -> dict:
        return self.execute(self.plan(max_moves=max_moves), step_cb=step_cb)


def skewed_weights(placement, loads: dict[int, float], damp: float = 2.0,
                   floor: float = 0.25, ceil: float = 4.0) -> dict[int, float]:
    """New ring weights inversely proportional to observed load.

    ``loads``: ops per active shard.  A shard at 2x the mean load sheds
    arc mass; an underloaded one grows.  The per-pass factor is damped to
    [1/damp, damp] — a single window (e.g. a shard with no history yet)
    must not swing the ring hard enough to *relocate* the hot spot
    instead of dispersing it; repeated passes converge.  Absolute weights
    clamp to [floor, ceil].
    """
    ids = list(placement.shard_ids)
    total = sum(loads.get(s, 0.0) for s in ids)
    if total <= 0:
        return {s: placement.weight_of(s) for s in ids}
    mean = total / len(ids)
    out = {}
    for s in ids:
        factor = mean / max(loads.get(s, 0.0), mean / damp)
        factor = min(damp, max(1.0 / damp, factor))
        out[s] = min(ceil, max(floor, placement.weight_of(s) * factor))
    return out
