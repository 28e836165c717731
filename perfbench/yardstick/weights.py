"""Weights drawn from the seed, the same for the program and the reference.

Every leaf whose ``init`` is "normal" takes its values from one flat
stream of N(0, 1) · 0.02 draws in fp32, in the order of the leaf list
(``refmodel.leaves``), cast to the leaf's storage dtype; a "ones" leaf (a
norm scale) is 1.  The stream is drawn in chunks of ``CHUNK`` elements on
the card, chunk c from a ``torch.Generator`` seeded with
``chunk_seed(seed, c)``, so a few large calls fill the model and any
chunk can be drawn again alone: ``fill`` writes the program's tensors
(or the reference's), ``change_sq`` reads how far tensors moved from
what was drawn, chunk by chunk, without a second copy of the weights.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 27
SCALE = 0.02


def chunk_seed(seed: int, c: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (c + 1)) % (1 << 63)


def _spans(leaves):
    """(leaf, first element of the leaf in the stream) of "normal" leaves,
    and the stream's length."""
    out, off = [], 0
    for leaf in leaves:
        if leaf.init == "normal":
            out.append((leaf, off))
            off += math.prod(leaf.shape)
    return out, off


def _chunks(leaves, seed: int, device):
    """(leaf, [a, b) of the leaf's flat elements, the fp32 values) for
    every piece of every "normal" leaf, chunk by chunk."""
    spans, total = _spans(leaves)
    i = 0
    for c0 in range(0, total, CHUNK):
        c1 = min(total, c0 + CHUNK)
        gen = torch.Generator(device=device)
        gen.manual_seed(chunk_seed(seed, c0 // CHUNK))
        x = torch.randn(c1 - c0, generator=gen, device=device,
                        dtype=torch.float32).mul_(SCALE)
        while i < len(spans):
            leaf, off = spans[i]
            n = math.prod(leaf.shape)
            lo, hi = max(off, c0), min(off + n, c1)
            if lo >= hi:
                break
            yield leaf, lo - off, hi - off, x[lo - c0:hi - c0]
            if off + n > c1:
                break
            i += 1
        del x


def _flat(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("weights are filled into contiguous tensors")
    return t.view(-1)


@torch.no_grad()
def fill(dests: dict, leaves, seed: int, device) -> None:
    """Write every leaf's drawn values into ``dests[leaf.name]`` (a
    tensor of the leaf's shape and dtype)."""
    for leaf in leaves:
        t = dests[leaf.name]
        if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
            raise ValueError(f"{leaf.name}: {tuple(t.shape)} {t.dtype}, "
                             f"the configuration says {leaf.shape} "
                             f"{leaf.dtype}")
        if leaf.init == "ones":
            t.fill_(1.0)
    for leaf, a, b, x in _chunks(leaves, seed, device):
        _flat(dests[leaf.name])[a:b].copy_(x)


@torch.no_grad()
def change_sq(current: dict, leaves, seed: int, device) -> dict:
    """Per leaf, the sum of squares (float) of ``current[name]`` minus its
    drawn value, both as stored, in fp32."""
    acc = {leaf.name: torch.zeros((), dtype=torch.float64, device=device)
           for leaf in leaves}
    for leaf in leaves:
        if leaf.init == "ones":
            d = current[leaf.name].float() - 1.0
            acc[leaf.name] += torch.sum(d * d).double()
    for leaf, a, b, x in _chunks(leaves, seed, device):
        diff = _flat(current[leaf.name])[a:b].float() - \
            x.to(leaf.dtype).float()
        acc[leaf.name] += torch.sum(diff * diff).double()
    return {k: float(v) for k, v in acc.items()}
