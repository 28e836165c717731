"""Data pipeline: deterministic synthetic LM batches.

The port of the JAX package's ``data/pipeline.py``: the same numpy draws
(a Zipf-ranked token stream, fully deterministic in (seed, step, host)),
returned as torch tensors on the pipeline's device (None: the card).
Tokens and labels are int32, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import dispatch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    embed_dim: int = 0        # >0 -> embeddings-mode batches (audio/vlm stubs)
    mrope: bool = False


class SyntheticLM:
    """batch(step) -> {tokens|embeddings, labels[, positions]}."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        # precompute a Zipf remap table: rank -> token id
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def _rng(self, step: int, host: int = 0):
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 977 + host)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def batch(self, step: int, host: int = 0, host_count: int = 1) -> dict:
        cfg = self.cfg
        per_host = cfg.global_batch // host_count
        rng = self._rng(step, host)
        ranks = rng.zipf(cfg.zipf_a, size=(per_host, cfg.seq_len + 1))
        toks = self.perm[np.clip(ranks - 1, 0, cfg.vocab_size - 1)]
        out = {}
        if cfg.embed_dim:
            emb = rng.standard_normal(
                (per_host, cfg.seq_len, cfg.embed_dim)).astype(np.float32)
            out["embeddings"] = self._tensor(emb * 0.02)
        else:
            out["tokens"] = self._tensor(toks[:, :-1].astype(np.int32))
        out["labels"] = self._tensor(toks[:, 1:].astype(np.int32))
        if cfg.mrope:
            pos = np.broadcast_to(np.arange(cfg.seq_len, dtype=np.int32),
                                  (3, per_host, cfg.seq_len))
            out["positions"] = self._tensor(pos)
        return out
