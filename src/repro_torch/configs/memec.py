"""The paper's own system configuration (MemEC §7 testbed).

16 servers, 4 proxies, 1 coordinator; (n,k)=(10,8); c=16 stripe lists;
4 KB chunks; RS or RDP coding; YCSB-style workloads with 24-byte keys and
8/32-byte values.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class MemECConfig:
    num_servers: int = 16
    num_proxies: int = 4
    scheme: str = "rs"          # rs | rdp | xor | none
    n: int = 10
    k: int = 8
    c: int = 16                 # stripe lists
    chunk_size: int = 4096
    max_unsealed: int = 4
    key_size: int = 24
    value_sizes: tuple = (8, 32)
    # batched coding-engine backend: numpy | torch | torch:cpu | cuda |
    # cuda:cpu (see core/engine.py).  None defers to $MEMEC_TORCH_ENGINE,
    # default cuda (the hand-written kernels, for every scheme).  A
    # comma-separated list assigns backends per shard (cycling), e.g.
    # "cuda,numpy" = kernels on even shards, numpy on odd.
    engine: str | None = None
    # multi-key request batch size for the batched client API / YCSB
    # driver (1 = classic per-key requests)
    batch_size: int = 1
    # shard count for core/shard.py's ShardedCluster (hash of key ->
    # shard; each shard is an independent paper-testbed cluster).  1 =
    # the paper's single unsharded cluster; None defers to $MEMEC_SHARDS.
    shards: int | None = 1
    # key->shard placement policy (core/ring.py): "mod" (historical
    # FNV-mod), "ring" / "ring:<vnodes>" (elastic consistent-hash ring —
    # required for add_shard/remove_shard/rebalance).  None defers to
    # $MEMEC_PLACEMENT, default "mod".
    placement: str | None = None
    # intra-shard async coding pipeline (core/store.py): submit engine
    # work through futures while the shard's own netsim legs are in
    # flight — request latency charges max(coding, network) per phase
    # instead of the serial sum.  Byte-identical to the sync pipeline.
    # None defers to $MEMEC_ASYNC, default off.
    async_engine: bool | None = None


CONFIG = MemECConfig()


def make_configured_cluster(cfg: MemECConfig = CONFIG, **overrides):
    """Build the cluster this config describes (sharded iff shards > 1)."""
    from ..core.shard import make_cluster
    kw = dict(num_servers=cfg.num_servers, num_proxies=cfg.num_proxies,
              scheme=cfg.scheme, n=cfg.n, k=cfg.k, c=cfg.c,
              chunk_size=cfg.chunk_size, max_unsealed=cfg.max_unsealed,
              engine=cfg.engine, shards=cfg.shards, placement=cfg.placement,
              async_engine=cfg.async_engine)
    kw.update(overrides)
    return make_cluster(**kw)
