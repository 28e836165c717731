"""What the drivers share: the program under test built from a
configuration file, its weights drawn from the seed, its erasure-coded
copy, the deployment's optimizer, and the profiler around the iterations
a traced run adds after its window.

Only the drivers import the program (``repro_torch``), and only its public
entry points: ``Model``, ``param_tree``, ``make_optimizer``,
``make_train_step``, ``ECCheckpoint`` with ``ECConfig``, ``param_specs``,
``make_mesh``, and the kernel library's ``build`` and ``library``.
"""
from __future__ import annotations

import functools
import time

import torch

from yardstick import card, refmodel, weights
from yardstick.trace import Trace


def build_model(conf: dict, seed: int, dev):
    """(program config, ``Model``, {name: parameter}, the reference's leaf
    list): the model at the configuration's shapes, its weights drawn
    from ``seed`` (``weights.fill``)."""
    from repro_torch.models import Model
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(**conf["model"])
    model = Model(cfg, device=dev)
    named = dict(model.named_parameters())
    specs = refmodel.leaves(conf)
    if sorted(named) != sorted(leaf.name for leaf in specs):
        raise ValueError("the program's parameters are not the "
                         "configuration's: "
                         f"{sorted(set(named) ^ {l.name for l in specs})}")
    weights.fill(named, specs, seed, dev)
    return cfg, model, named, specs


def ec_copy(conf: dict, cfg, params):
    """(``ECCheckpoint`` over the deployment's mesh with its code, created
    from ``params``; the data axis's size; the code's (k, m, page))."""
    from repro_torch.distributed.ecstore import ECConfig
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import ECCheckpoint
    dep = conf["deployment"]
    mesh = make_mesh([s for _, s in dep["mesh"]], [a for a, _ in dep["mesh"]])
    code = dep["ec"]
    ec = ECCheckpoint(mesh, param_specs(cfg, params, mesh),
                      ECConfig(k=code["k"], m=code["m"],
                               page_size=code["page_size"], axis="data"))
    ec.create(params)
    return ec, dict(dep["mesh"])["data"], (code["k"], code["m"],
                                           code["page_size"])


def optimizer(conf: dict):
    """The deployment's optimizer (``deployment.optimizer``) as the
    program makes it."""
    from repro_torch.train.optimizer import make_optimizer
    hp = conf["deployment"]["optimizer"]
    return make_optimizer(hp["name"], lr=hp["lr"], b1=hp["b1"], b2=hp["b2"],
                          eps=hp["eps"], weight_decay=hp["weight_decay"],
                          warmup_steps=hp["warmup_steps"],
                          total_steps=hp["total_steps"])


def kernel_library(dev) -> dict:
    """Load the program's CUDA kernels (built by nvcc into the checkout's
    ``build/`` on a checkout's first run) before anything else is timed:
    the seconds it took and whether this run built them."""
    if dev.type != "cuda":
        return {"kernel_library_s": 0.0, "kernels_built": False}
    from repro_torch.kernels import _build
    t0, wall = time.perf_counter(), time.time()
    lib = _build.build()
    _build.library()
    return {"kernel_library_s": time.perf_counter() - t0,
            "kernels_built": lib.stat().st_mtime >= wall - 1.0}


def spanned(name: str, fn):
    """``fn`` inside a ``record_function`` range named ``name``."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def profiled(dev, iters: int, one, spans) -> Trace:
    """``one(i)`` for i = -1 (a warm-up under the profiler, its events
    dropped: the profiler's own start-up stays out) and then
    i = 0 .. iters - 1 profiled, each followed by a wait; the ``Trace``
    of those ``iters``, read and the profile freed before returning.
    ``window_s`` is the host-clock time from the wait after the warm-up
    to the wait after the last iteration."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=iters, repeat=1)) as prof:
        one(-1)
        card.sync(dev)
        prof.step()
        t0 = time.perf_counter()
        for i in range(iters):
            one(i)
            card.sync(dev)
            if i == iters - 1:
                window_s = time.perf_counter() - t0
            prof.step()
    trace = Trace.from_profile(prof, spans, window_s, iters)
    del prof
    return trace


def free_all(dev, *holders) -> None:
    for h in holders:
        h.clear()
    card.free(dev)
