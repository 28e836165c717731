"""Rank bodies for ``tests/test_torch_model_ranks.py``.

``repro_torch.distributed.ranks.launch`` runs these in spawned processes,
one per mesh position, so they live in a module the ranks can import.  It
imports no JAX.  A rank answers with numpy arrays (pickled by value), not
tensors: it exits right after answering.
"""
import numpy as np
import torch

from repro_torch.distributed.collectives import recording
from repro_torch.distributed.ranks import rank_comms
from repro_torch.models import layers
from repro_torch.models.ranked import RankModel, batch_rows
from repro_torch.serve.engine import ServeEngine


def _sent(fn, *args):
    """``fn(*args)`` and the bytes this rank sent in it, by kind."""
    sent: dict = {}
    with recording(lambda n, kind: sent.__setitem__(kind, sent.get(kind, 0)
                                                    + n)):
        out = fn(*args)
    return out, sent


def model_body(comm, jobs, tokens, prompt_len, steps):
    """For each (name, cfg, blocks) of ``jobs``: ``RankModel.apply`` on
    ``tokens`` (its logits block and the bytes it sent), greedy decoding
    through ``ServeEngine`` (an fp32 cache; the whole batch's tokens and
    the logits block after the prompt's token-by-token prefill), and one
    ``decode_step`` at the last slot of a cache as long as ``tokens``,
    the step the dry run counts (its bytes sent)."""
    torch.set_num_threads(1)
    layers.set_activation_mesh(rank_comms(comm))
    B, S = tokens.shape
    out = {}
    try:
        for name, cfg, blocks in jobs:
            model = RankModel(cfg, blocks)
            layers.reset_op_paths()
            logits, sent_prefill = _sent(model.apply, {"tokens": tokens})
            eng = ServeEngine(model, max_len=prompt_len + steps,
                              batch_size=B, cache_dtype=torch.float32,
                              device="cpu")
            dec_logits = eng.prefill({"tokens": tokens[:, :prompt_len]})
            first = model.argmax(dec_logits)
            rest = eng.decode(steps - 1, first_tokens=first)
            cache = model.init_cache(B, S, dtype=torch.bfloat16)
            _, sent_decode = _sent(model.decode_step, cache, tokens[:, 0],
                                   S - 1)
            out[name] = dict(
                coords=comm.coords,
                rows=batch_rows(B, comm.axis_size, comm.index),
                logits=logits.numpy(), dec_logits=dec_logits.numpy(),
                tokens=np.concatenate([first[:, None].numpy(), rest.tokens],
                                      axis=1),
                sent_prefill=sent_prefill, sent_decode=sent_decode,
                op_paths=dict(model.op_paths),
                routes=dict(layers.OP_PATHS))
    finally:
        layers.set_activation_mesh(None)
    return out
