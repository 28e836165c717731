"""Traffic drawn from the seed.

``lm_batches``: language-model batches of a Zipf-ranked token stream (a
frozen copy of the arithmetic of the port's ``SyntheticLM``: a seeded
permutation maps Zipf ranks to token ids, each batch from its own
generator), tokens and labels int32 on the device.  Every seed gives the
same shapes; only the ids differ.

``positions``: the data positions a failure workload loses, one draw per
iteration, uniform over the positions.

``sample``: indices drawn from the seed, for the answers a check reads.
"""
from __future__ import annotations

import numpy as np
import torch


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


def lm_batches(seed: int, count: int, batch: int, seq: int, vocab: int,
               zipf_a: float, device) -> list:
    perm = _rng(seed, 1).permutation(vocab)
    out = []
    for step in range(count):
        ranks = _rng(seed, 2, step).zipf(zipf_a, size=(batch, seq + 1))
        toks = perm[np.clip(ranks - 1, 0, vocab - 1)].astype(np.int32)
        out.append({
            "tokens": torch.from_numpy(np.ascontiguousarray(
                toks[:, :-1])).to(device),
            "labels": torch.from_numpy(np.ascontiguousarray(
                toks[:, 1:])).to(device)})
    return out


def positions(seed: int, count: int, axis: int) -> list:
    return [int(x) for x in _rng(seed, 3).integers(0, axis, size=count)]


def sample(seed: int, count: int, below: int) -> list:
    return sorted(int(x) for x in _rng(seed, 4).choice(
        below, size=min(count, below), replace=False))
