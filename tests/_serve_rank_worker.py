"""Rank bodies for ``tests/test_torch_serve_ranks.py``.

``repro_torch.distributed.ranks.launch`` runs these in spawned processes,
one per mesh position, so they live in a module the ranks can import.  It
imports no JAX.  A rank answers with numpy arrays (pickled by value), not
tensors: it exits right after answering.
"""
import numpy as np
import torch

import _train_rank_worker
from repro_torch.distributed import sharding
from repro_torch.distributed.ecstore import ECConfig
from repro_torch.distributed.ranks import rank_comms
from repro_torch.models import layers
from repro_torch.models.ranked import RankModel
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import leaves, leaves_with_path, path_str


def _cache_leaves(eng) -> dict:
    """The rank's cache block by tree path, the stacked leaves as one
    array each."""
    return {path_str(k): np.stack([p.numpy() for p in t.parts])
            if hasattr(t, "parts") else t.numpy()
            for k, t in leaves_with_path(eng.cache_tree())}


def _protect(comms, cfg, blocks, prompt, steps, max_len, ec) -> dict:
    """A protected serving session of ``cfg`` on this rank: the prompt's
    token-by-token prefill, ``protect_cache`` over the data column by
    ``cache_specs`` of the engine's ``cache_shapes``, a snapshot, ``steps``
    greedy decode steps, ``refresh_cache_parity``; the rank's cache block,
    its pages and parity at each point, a fresh encode of the decoded
    cache, and the rebuilds of every data position."""
    model = RankModel(cfg, blocks, comms)
    B = prompt.shape[0]
    eng = ServeEngine(model, max_len=max_len, batch_size=B, device="cpu",
                      cache_dtype=torch.float32)
    first = model.argmax(eng.prefill({"tokens": prompt}))
    mesh = comms.mesh
    specs = sharding.cache_specs(cfg, eng.cache_shapes(), mesh)
    eng.protect_cache(mesh, specs, ECConfig(**ec))
    out = {"prefill_cache": _cache_leaves(eng),
           "prefill_pages": eng.ec_store.local_pages(eng.cache_tree())
           .numpy(),
           "prefill_parity": eng.ec_parity.numpy(),
           "n_leaves": len(leaves(eng.cache_tree()))}
    old = eng.cache_snapshot()
    eng.decode(steps, first_tokens=first)
    eng.refresh_cache_parity(old)
    out.update(
        cache=_cache_leaves(eng),
        pages=eng.ec_store.local_pages(eng.cache_tree()).numpy(),
        parity=eng.ec_parity.numpy(),
        fresh=eng.ec_store.encode(eng.cache_tree()).numpy(),
        rebuilt=[eng.recover_cache_pages(f).numpy()
                 for f in range(comms.data.axis_size)],
        cur_len=eng.cur_len, op_paths=dict(comms.data.op_paths))
    return out


def serve_body(comm, protect, train, sessions=()):
    """``protect``: (cfg, blocks, prompt, steps, max_len, ec) for
    ``_protect``; ``train``: (name, cfg, blocks, batch, seq) jobs, each
    two AdamW steps through ``_train_rank_worker._job`` (``train_on_rank``
    with its EC copy; the second step's bytes are counted);
    ``sessions``: (name, the arguments of ``_protect``) of other archs'
    sessions, each answered under its name."""
    torch.set_num_threads(1)
    comms = rank_comms(comm)
    layers.set_activation_mesh(comms)
    try:
        out = {"coords": comm.coords, "protect": _protect(comms, *protect)}
        for name, args in sessions:
            out[name] = _protect(comms, *args)
        for name, cfg, blocks, batch, seq in train:
            out[name] = _train_rank_worker._job(comms, cfg, blocks, batch,
                                                seq, 2)
    finally:
        layers.set_activation_mesh(None)
    return out
