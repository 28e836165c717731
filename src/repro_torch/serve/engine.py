"""Serving engine: batched prefill + decode over the port's ``Model``.

The port of the JAX package's ``serve/engine.py``.  ``prefill`` runs the
prompt token by token through ``Model.decode_step`` into the KV cache, as
the reference's does (``Model.apply`` is the fused full-sequence
forward); ``decode`` then generates greedily, or samples at
``temperature > 0`` from the engine's ``torch.Generator``.  The cache is
written in place.

On a rank of a (data, model) mesh the model is a
``models.ranked.RankModel``: the engine takes the whole batch on every
rank, the cache is the rank's block, and greedy decoding returns the
whole batch's tokens on every rank (``RankModel.argmax`` gathers the
vocab-sharded argmax), the tokens of one device.  Sampling at
``temperature > 0`` and ``protect_cache`` are not ported across ranks
(ROADMAP.md Queue 1) and raise there.

The serving state of every layer kind - attention KV (a local layer's
ring, an int8 cache with its scales), MLA latents, Mamba-2 and RG-LRU
states - can be erasure-coded across a mesh's data axis exactly like
checkpoint pages (``protect_cache``), in the reference's tree order: losing a position then costs a
decode-from-k reconstruction (``recover_cache_pages``) instead of
recomputing every live session's prefill - the paper's degraded GET
applied to serving state.  The cache is written in place, so
``refresh_cache_parity`` takes a copy of the cache as it was when the
parity last covered it (``cache_snapshot``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed.ecstore import ECConfig, ECStateStore
from ..kernels import dispatch
from ..models import Model


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
                self._one_device("sampling at temperature > 0")
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1,
                                        generator=self.generator)[:, 0]
            else:
                tok = self.model.argmax(logits)
            out.append(tok)
        tokens = (torch.stack(out, dim=1).cpu().numpy() if out
                  else np.zeros((self.batch_size, 0), np.int64))
        return GenerationResult(tokens, steps)

    def _one_device(self, what: str) -> None:
        if not isinstance(self.model, Model):
            raise NotImplementedError(
                f"{what} across ranks is not ported yet (ROADMAP.md Queue 1 "
                f"item 12 ports serve --protect; sampling follows it)")


    # -- EC protection of serving state -----------------------------------
    def cache_tree(self, cache: list[dict] | None = None) -> dict:
        """The cache (default: the live one) in the reference's stacked
        layout, what ``sharding.cache_specs`` and the EC store take."""
        return self.model.cache_tree(self.cache if cache is None else cache)

    def cache_snapshot(self) -> list[dict]:
        """A copy of the live cache."""
        return [{k: t.clone() for k, t in layer.items()}
                for layer in self.cache]

    def protect_cache(self, mesh, cache_specs, ec_cfg: ECConfig | None = None):
        self._one_device("protect_cache")
        self.ec_store = ECStateStore(mesh, cache_specs, ec_cfg)
        self.ec_parity = self.ec_store.encode(self.cache_tree())
        return self.ec_parity

    def refresh_cache_parity(self, old_cache: list[dict]):
        """Fold the cache's change since ``old_cache`` (a snapshot) into
        the parity."""
        assert self.ec_store is not None
        self.ec_parity = self.ec_store.delta_update(
            self.cache_tree(old_cache), self.cache_tree(), self.ec_parity)

    def recover_cache_pages(self, failed_data_index: int):
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
