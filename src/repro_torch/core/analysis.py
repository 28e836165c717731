"""Redundancy analysis of the three data models (paper §3.3, Figure 2).

Redundancy := (actual storage per object incl. fault-tolerance redundancy)
              / (K + V + M).

Defaults mirror the paper: M=4, R=8, C=4096, I=8, O=0.9.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AnalysisParams:
    K: float          # key size
    V: float          # value size
    n: int
    k: int
    M: float = 4.0    # metadata size
    R: float = 8.0    # reference size
    C: float = 4096.0  # chunk size
    I: float = 8.0    # chunk-ID size
    O: float = 0.9    # cuckoo-hash occupancy

    @property
    def object_size(self) -> float:
        return self.K + self.V + self.M


def redundancy_all_replication(p: AnalysisParams) -> float:
    """(n-k+1) full copies of (object + reference)."""
    copies = p.n - p.k + 1
    return copies * (p.K + p.V + p.M + p.R) / p.object_size


def redundancy_hybrid_encoding(p: AnalysisParams) -> float:
    """Replicate key+metadata+reference (n-k+1)x; erasure-code the value."""
    copies = p.n - p.k + 1
    return (copies * (p.K + p.M + p.R) + p.n * p.V / p.k) / p.object_size


def redundancy_all_encoding(p: AnalysisParams) -> float:
    """Erasure-code the whole object; local-only indexes (paper eq. §3.3)."""
    obj = p.object_size
    coded = p.n * obj / p.k
    obj_index = p.R / p.O
    objs_per_stripe = p.k * p.C / obj
    chunk_over = p.n * (p.I + p.R / p.O) / objs_per_stripe
    return (coded + obj_index + chunk_over) / obj


MODELS = {
    "all-replication": redundancy_all_replication,
    "hybrid-encoding": redundancy_hybrid_encoding,
    "all-encoding": redundancy_all_encoding,
}


def figure2_table(K: float, nk: tuple[int, int], values=None) -> dict:
    """Reproduce one panel of Figure 2: redundancy vs value size."""
    n, k = nk
    values = values if values is not None else [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]
    rows = {}
    for name, fn in MODELS.items():
        rows[name] = [fn(AnalysisParams(K=K, V=v, n=n, k=k)) for v in values]
    rows["V"] = list(values)
    return rows


def crossover_value(K: float, nk: tuple[int, int], target: float, model: str = "all-encoding",
                    vmax: int = 100000) -> int:
    """Smallest V at which `model` redundancy drops below `target`."""
    n, k = nk
    fn = MODELS[model]
    for v in range(1, vmax):
        if fn(AnalysisParams(K=K, V=v, n=n, k=k)) <= target:
            return v
    return -1


def xla_cost_analysis(compiled) -> dict:
    """Version-tolerant ``compiled.cost_analysis()``.

    jax <= 0.4.x returns a *list* of per-program dicts (one entry for a
    single-device program), newer jax returns the dict directly, and
    either may return None/empty for trivial programs.  Always hands
    back a plain dict so callers can ``.get("flops", 0)`` regardless of
    the installed jax.
    """
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else None
    return dict(cost) if cost else {}
