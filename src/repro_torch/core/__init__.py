"""MemEC core on PyTorch: the single-shard cluster and its coding engine.

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
* netsim / trace — the modeled network, event runtime and span tracing.

Sharding, placement, rebalancing, the baselines, the analysis formulas
and telemetry are not ported yet (ROADMAP Queue 1).
"""
from .chunk import CHUNK_SIZE, ChunkBuilder, ChunkId, ObjectRef
from .codes import Code, NoCode, RDPCode, RSCode, XORCode, make_code
from .coordinator import Coordinator, ServerState
from .engine import (CodingEngine, CudaEngine, DecodePlan, EngineFuture,
                     NumpyEngine, TorchEngine, make_engine, resolve_async)
from .index import CuckooIndex
from .netsim import (ArrivalProcess, CostModel, EventRuntime, LatencyRecorder,
                     Leg, NetSim, resolve_arrival)
from .proxy import Proxy
from .server import Server
from .store import MemECCluster, PartialFailure
from .stripe import StripeList, StripeMapper, generate_stripe_lists
from .trace import (Span, TraceCapture, Tracer, critical_paths,
                    describe_critical_path, export_chrome, resolve_trace,
                    validate_chrome)
from . import trace

__all__ = [
    "CHUNK_SIZE", "ChunkBuilder", "ChunkId", "ObjectRef", "Code", "NoCode",
    "RDPCode", "RSCode", "XORCode", "make_code", "CodingEngine",
    "CudaEngine", "DecodePlan", "EngineFuture", "NumpyEngine", "TorchEngine",
    "make_engine", "resolve_async", "Coordinator", "ServerState",
    "CostModel", "ArrivalProcess", "EventRuntime", "LatencyRecorder",
    "resolve_arrival", "Leg", "NetSim", "Proxy", "Server", "MemECCluster",
    "PartialFailure", "StripeList", "StripeMapper", "generate_stripe_lists",
    "trace", "Span", "Tracer", "TraceCapture", "critical_paths",
    "describe_critical_path", "export_chrome", "resolve_trace",
    "validate_chrome",
]
