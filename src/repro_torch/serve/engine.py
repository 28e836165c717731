"""Serving engine: batched prefill + decode over the port's ``Model``.

The port of the JAX package's ``serve/engine.py``.  ``prefill`` runs the
prompt token by token through ``Model.decode_step`` into the KV cache, as
the reference's does (``Model.apply`` is the fused full-sequence
forward); ``decode`` then generates greedily, or samples at
``temperature > 0`` from the engine's ``torch.Generator``.  The cache is
written in place.

On a rank of a (data, model) mesh the model is a
``models.ranked.RankModel``: the engine takes the whole batch on every
rank, the cache is the rank's block, and decoding returns the whole
batch's tokens on every rank, the tokens of one device: greedy through
``RankModel.argmax`` (the vocab-sharded argmax gathered), sampled
through ``RankModel.sample`` (the whole batch's logits gathered, then
the one-device draw from the engine's generator, seeded alike on every
rank).

The serving state of every layer kind - attention KV (a local layer's
ring, an int8 cache with its scales), MLA latents, Mamba-2 and RG-LRU
states - can be erasure-coded across a mesh's data axis exactly like
checkpoint pages (``protect_cache``), in the reference's tree order:
losing a position then costs a decode-from-k reconstruction
(``recover_cache_pages``) instead of recomputing every live session's
prefill - the paper's degraded GET applied to serving state.  On one
device the store holds every position stacked; on a rank it is the
rank's (``ECStateStore(comm=...)`` over its data column), packing the
rank's cache block by the specs of the whole cache
(``cache_shapes``), and a lost position's pages are rebuilt over the
ring.  The cache is written in place, so ``refresh_cache_parity`` takes
a copy of the cache as it was when the parity last covered it
(``cache_snapshot``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed.ecstore import ECConfig, ECStateStore
from ..kernels import dispatch
from ..models import Model
from ..models.ranked import RankModel


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray
    steps: int


class ServeEngine:
    """One batch of ``batch_size`` sequences of at most ``max_len``
    tokens on ``device`` (None: the card).  ``generator`` draws the
    samples at ``temperature > 0``; by default a generator on the device
    seeded with 0."""

    def __init__(self, model: Model, *, max_len: int, batch_size: int,
                 cache_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        dev = dispatch.resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model on {model.device}, engine on {dev}")
        self.model = model
        self.device = dev
        self.max_len = max_len
        self.batch_size = batch_size
        self.cache_dtype = cache_dtype
        self.cache = model.init_cache(batch_size, max_len, dtype=cache_dtype)
        self.cur_len = 0
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        self.generator = generator
        self.ec_store: ECStateStore | None = None
        self.ec_parity = None

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.cur_len >= self.max_len:
            raise ValueError(f"the cache holds {self.max_len} tokens")
        logits, self.cache = self.model.decode_step(self.cache, tokens,
                                                    self.cur_len)
        self.cur_len += 1
        return logits

    # -- serving ---------------------------------------------------------
    def prefill(self, batch: dict) -> torch.Tensor:
        """Run the prompt token by token into the cache: batch["tokens"]
        (B, S), or for an embeddings config batch["embeddings"] (B, S, d),
        fed as (B, 1, d) steps; returns the logits after its last
        token."""
        if "embeddings" in batch:
            emb = torch.as_tensor(batch["embeddings"], device=self.device)
            steps = [emb[:, t:t + 1] for t in range(emb.shape[1])]
        else:
            toks = torch.as_tensor(batch["tokens"], device=self.device)
            steps = [toks[:, t] for t in range(toks.shape[1])]
        logits = None
        for step in steps:
            logits = self._step(step)
        return logits

    def decode(self, steps: int, temperature: float = 0.0,
               first_tokens=None) -> GenerationResult:
        """Feed ``first_tokens`` (B,) and generate ``steps`` tokens, each
        fed back in; returns them as a (B, steps) host array."""
        out = []
        tok = torch.as_tensor(first_tokens, device=self.device)
        for _ in range(steps):
            logits = self._step(tok)
            if temperature > 0:
                tok = self.model.sample(logits, temperature, self.generator)
            else:
                tok = self.model.argmax(logits)
            out.append(tok)
        tokens = (torch.stack(out, dim=1).cpu().numpy() if out
                  else np.zeros((self.batch_size, 0), np.int64))
        return GenerationResult(tokens, steps)

    # -- EC protection of serving state -----------------------------------
    def cache_tree(self, cache: list[dict] | None = None) -> dict:
        """The cache (default: the live one; on a rank, its block) in the
        reference's stacked layout, what the EC store packs."""
        return self.model.cache_tree(self.cache if cache is None else cache)

    def cache_shapes(self) -> dict:
        """The whole cache's leaves in the reference's layout, what
        ``sharding.cache_specs`` places: the live cache on one device,
        ``meta`` tensors of the global shapes on a rank."""
        if isinstance(self.model, RankModel):
            return self.model.cache_shapes(self.batch_size, self.max_len,
                                           self.cache_dtype)
        return self.cache_tree()

    def cache_snapshot(self) -> list[dict]:
        """A copy of the live cache."""
        return [{k: t.clone() for k, t in layer.items()}
                for layer in self.cache]

    def protect_cache(self, mesh, cache_specs, ec_cfg: ECConfig | None = None):
        """Erasure-code the cache over ``mesh``'s data axis by
        ``cache_specs`` (``sharding.cache_specs`` of ``cache_shapes``); on
        a rank, over the model's mesh with the rank's data column."""
        comm = self.model.comms.data if isinstance(self.model, RankModel) \
            else None
        self.ec_store = ECStateStore(mesh, cache_specs, ec_cfg, comm=comm)
        self.ec_parity = self.ec_store.encode(self.cache_tree())
        return self.ec_parity

    def refresh_cache_parity(self, old_cache: list[dict]):
        """Fold the cache's change since ``old_cache`` (a snapshot) into
        the parity."""
        assert self.ec_store is not None
        self.ec_parity = self.ec_store.delta_update(
            self.cache_tree(old_cache), self.cache_tree(), self.ec_parity)

    def recover_cache_pages(self, failed_data_index: int):
        """The pages of data position ``failed_data_index`` rebuilt from
        the survivors (every position's, stacked; a rank's column's on a
        rank)."""
        assert self.ec_store is not None
        return self.ec_store.reconstruct(self.cache_tree(), self.ec_parity,
                                         failed_data_index)


def greedy_generate(model: Model, prompt_tokens, steps: int,
                    max_len: int | None = None) -> np.ndarray:
    """One-shot greedy generation on the model's device: (B, S) prompt
    -> (B, steps) host array of generated tokens (a ``RankModel``: the
    whole batch's, on every rank)."""
    B, S = prompt_tokens.shape
    eng = ServeEngine(model, max_len=max_len or (S + steps), batch_size=B,
                      device=model.device)
    logits = eng.prefill({"tokens": prompt_tokens})
    first = model.argmax(logits)
    if steps <= 1:
        return first[:, None].cpu().numpy()[:, :steps]
    res = eng.decode(steps - 1, first_tokens=first)
    return np.concatenate([first[:, None].cpu().numpy(), res.tokens], axis=1)
