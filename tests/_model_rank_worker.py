"""Rank bodies for ``tests/test_torch_model_ranks.py``.

``repro_torch.distributed.ranks.launch`` runs these in spawned processes,
one per mesh position, so they live in a module the ranks can import.  It
imports no JAX.  A rank answers with numpy arrays (pickled by value), not
tensors: it exits right after answering.
"""
import numpy as np
import torch

from repro_torch.distributed.collectives import recording
from repro_torch.distributed.ranks import CountingComm, rank_comms
from repro_torch.models import layers, moe
from repro_torch.models.ranked import RankModel, batch_rows
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import leaves_with_path, materialize, path_str

#: the seed of the engine's generator when it samples
SAMPLE_SEED = 7


class ShapeComm(CountingComm):
    """A ``CountingComm`` that keeps the shape and dtype of every block it
    all-gathers or all-reduces (``gathered``, ``reduced``)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.gathered, self.reduced = [], []

    def all_gather(self, x):
        self.gathered.append((tuple(x.shape), x.dtype))
        return super().all_gather(x)

    def all_reduce(self, x, op="sum"):
        self.reduced.append((tuple(x.shape), x.dtype))
        return super().all_reduce(x, op)


def _sent(fn, *args):
    """``fn(*args)`` and the bytes this rank sent in it, by kind."""
    sent: dict = {}
    with recording(lambda n, kind: sent.__setitem__(kind, sent.get(kind, 0)
                                                    + n)):
        out = fn(*args)
    return out, sent


def model_body(comm, jobs, prompt_len, sample_logits=None):
    """For each (name, cfg, blocks, batch, steps) of ``jobs``:
    ``RankModel.apply`` on ``batch`` (its logits block and the bytes it
    sent), greedy decoding through ``ServeEngine`` (an fp32 cache; the
    whole batch's tokens and the logits block after the prompt's
    token-by-token prefill, the prompt being the batch's first
    ``prompt_len`` tokens or embeddings, and the rank's cache block after
    it, by tree path), the same decoding sampled at
    temperature 1.0 from a generator seeded with ``SAMPLE_SEED``, and one
    ``decode_step`` at the last slot of a cache as long as the batch, the
    step the dry run counts (its bytes sent); both decodings start from
    the cache the prompt left.  An MoE config's prefill also gives each
    layer's top-K experts and keep flags of the rank's rows
    (``moe.record_routes``) and its dropped assignments
    (``moe.dropped_assignments``).  ``sample_logits`` (B, V):
    the tokens ``RankModel.sample`` draws from this rank's block of
    them."""
    torch.set_num_threads(1)
    layers.set_activation_mesh(rank_comms(comm))
    out = {}
    try:
        for name, cfg, blocks, batch, steps in jobs:
            model = RankModel(cfg, blocks)
            layers.reset_op_paths()
            moe.reset_drops()
            with moe.record_routes() as routes:
                logits, sent_prefill = _sent(model.apply, batch)
            drops = moe.dropped_assignments()
            inp = batch.get("embeddings", batch.get("tokens"))
            B, S = inp.shape[:2]
            prompt = ({"embeddings": inp[:, :prompt_len]} if inp.dim() == 3
                      else {"tokens": inp[:, :prompt_len]})
            eng = ServeEngine(model, max_len=prompt_len + steps,
                              batch_size=B, cache_dtype=torch.float32,
                              device="cpu")
            eng.generator.manual_seed(SAMPLE_SEED)
            dec_logits = eng.prefill(prompt)
            first = model.argmax(dec_logits)
            after_prompt = eng.cache_snapshot()
            tokens, caches = [], []
            for temperature in (0.0, 1.0):     # both from the prompt's cache
                eng.cache = [{k: t.clone() for k, t in c.items()}
                             for c in after_prompt]
                eng.cur_len = prompt_len
                rest = eng.decode(steps - 1, temperature=temperature,
                                  first_tokens=first)
                tokens.append(np.concatenate([first[:, None].numpy(),
                                              rest.tokens], axis=1))
                caches.append({path_str(k): materialize(t).numpy().copy()
                               for k, t in leaves_with_path(
                                   eng.cache_tree())})
            cache = model.init_cache(B, S, dtype=torch.bfloat16)
            step_in = inp[:, :1] if inp.dim() == 3 else inp[:, 0]
            _, sent_decode = _sent(model.decode_step, cache, step_in, S - 1)
            out[name] = dict(
                coords=comm.coords,
                rows=batch_rows(B, comm.axis_size, comm.index),
                logits=logits.numpy(), dec_logits=dec_logits.numpy(),
                tokens=tokens[0], sampled=tokens[1], cache=caches[0],
                sent_prefill=sent_prefill, sent_decode=sent_decode,
                moe_routes=[r.numpy() for r in routes],
                moe_kept=[k.numpy() for k in routes.kept], drops=drops,
                op_paths=dict(model.op_paths),
                routes=dict(layers.OP_PATHS))
        if sample_logits is not None:
            out["sampler"] = _sampler(model, sample_logits)
    finally:
        layers.set_activation_mesh(None)
    return out


def _sampler(model, logits):
    """``RankModel.sample`` at temperature 1.0 on this rank's block
    (rows, vocab block) of the whole batch's ``logits`` (a batch of the
    last decode step's size), from a generator seeded with
    ``SAMPLE_SEED``."""
    B, V = logits.shape
    r0, r1 = model.rows(B)
    Vl = V // model.M
    gen = torch.Generator().manual_seed(SAMPLE_SEED)
    block = logits[r0:r1, model.m * Vl:(model.m + 1) * Vl]
    return model.sample(block, 1.0, gen).numpy()


def mamba_decode_body(comm, cfg, blocks, tokens):
    """``RankModel.decode_step`` of ``cfg`` (Mamba-2 layers) on this
    rank's blocks (on the card when they are), one step a column of
    ``tokens`` (B, T) from an empty fp32 cache: the logits block of each
    step and the cache block after the last, by layer."""
    if blocks["final_norm"]["scale"].is_cuda:
        torch.cuda.set_device(0)
    layers.set_activation_mesh(rank_comms(comm))
    try:
        model = RankModel(cfg, blocks)
        B, T = tokens.shape
        cache = model.init_cache(B, T, dtype=torch.float32)
        logits = []
        for t in range(T):
            lg, cache = model.decode_step(cache, tokens[:, t], t)
            logits.append(lg.cpu().numpy())
        return dict(coords=comm.coords, logits=np.stack(logits, axis=1),
                    cache=[{k: v.cpu().numpy() for k, v in c.items()}
                           for c in cache])
    finally:
        layers.set_activation_mesh(None)
