"""MemEC core on PyTorch: the cluster, sharded or not, and its coding engine.

Layers:
* gf256 / codes — GF(2^8) arithmetic + RS/RDP/XOR erasure codes with
  delta-based parity updates (paper §2);
* engine — the unified batched coding data plane: one `CodingEngine`
  interface with numpy / torch / cuda backends, shared by servers, the
  cluster's batched request paths, and batched recovery.  Backend
  selection: the `engine=` constructor knob (configs/memec.py) or the
  `MEMEC_TORCH_ENGINE` env var;
* chunk / index / stripe — the all-encoding data model: 4KB chunk packing,
  cuckoo-hash object & chunk indexes, write-balanced stripe lists (§3, §4.3);
* server / proxy / coordinator / store — the cluster: decentralized
  normal-mode requests (single-key and batched multi_get/multi_set/
  multi_update), coordinated degraded mode, server states, backups,
  one-shot batched recovery, migration (§4, §5);
* hotkey — the version-buffered hot-key update tier;
* shard — the scale-out layer: `ShardedCluster` hash-partitions the key
  space across S independent shard stores (own stripe lists, coordinator,
  `CodingEngine` — mixed backends allowed through `engine_specs`), plans
  multi-key requests across shards with pipelined scatter/gather, and
  scopes failure recovery per shard.  `make_cluster(shards=...)` /
  `$MEMEC_SHARDS`; S=1 returns the plain `MemECCluster`;
* ring / rebalance — elastic placement (FNV-mod or a consistent-hash
  ring, `placement=` / `$MEMEC_PLACEMENT`), live stripe migration and
  skew-aware rebalancing via `ShardedCluster.add_shard/remove_shard/
  rebalance`;
* netsim / trace / telemetry — the modeled network, event runtime, span
  tracing with critical-path attribution and Chrome export, and the
  versioned telemetry snapshot;
* baselines — all-replication + hybrid-encoding comparison stores (§3.1);
* analysis — the redundancy formulas of §3.3 (Figure 2).
"""
from .analysis import (AnalysisParams, redundancy_all_encoding,
                       redundancy_all_replication, redundancy_hybrid_encoding)
from .baselines import AllReplicationCluster, HybridEncodingCluster
from .chunk import CHUNK_SIZE, ChunkBuilder, ChunkId, ObjectRef
from .codes import Code, NoCode, RDPCode, RSCode, XORCode, make_code
from .coordinator import Coordinator, ServerState
from .engine import (CodingEngine, CudaEngine, DecodePlan, EngineFuture,
                     NumpyEngine, TorchEngine, engine_specs, make_engine,
                     resolve_async)
from .index import CuckooIndex
from .netsim import (ArrivalProcess, CostModel, EventRuntime, LatencyRecorder,
                     Leg, NetSim, resolve_arrival)
from .proxy import Proxy
from .rebalance import MigrationPlan, Rebalancer
from .ring import ModPlacement, Placement, RingPlacement, make_placement
from .server import Server
from .shard import (ShardedCluster, ShardedNet, make_cluster, resolve_shards,
                    shard_for_key)
from .store import MemECCluster, PartialFailure
from .stripe import StripeList, StripeMapper, generate_stripe_lists
from .trace import (Span, TraceCapture, Tracer, critical_paths,
                    describe_critical_path, export_chrome, resolve_trace,
                    validate_chrome)
from . import telemetry
from . import trace

__all__ = [
    "AnalysisParams", "redundancy_all_encoding", "redundancy_all_replication",
    "redundancy_hybrid_encoding", "AllReplicationCluster",
    "HybridEncodingCluster", "CHUNK_SIZE", "ChunkBuilder", "ChunkId",
    "ObjectRef", "Code", "NoCode", "RDPCode", "RSCode", "XORCode",
    "make_code", "CodingEngine", "CudaEngine", "DecodePlan", "EngineFuture",
    "NumpyEngine", "TorchEngine", "make_engine", "resolve_async",
    "engine_specs", "CuckooIndex", "Coordinator", "ServerState",
    "CostModel", "ArrivalProcess", "EventRuntime", "LatencyRecorder",
    "resolve_arrival", "Leg", "NetSim", "Proxy", "Server", "MemECCluster",
    "PartialFailure", "ShardedCluster", "ShardedNet", "make_cluster",
    "resolve_shards", "shard_for_key", "StripeList", "StripeMapper",
    "generate_stripe_lists", "Placement", "ModPlacement", "RingPlacement",
    "make_placement", "Rebalancer", "MigrationPlan", "telemetry", "trace",
    "Span", "Tracer", "TraceCapture", "critical_paths",
    "describe_critical_path", "export_chrome", "resolve_trace",
    "validate_chrome",
]
