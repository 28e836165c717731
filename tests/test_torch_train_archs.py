"""One training step of every arch against the JAX package's: each of
the ten reduced configs in float32 on the CPU, from the reference's own
weights (``models.convert.params_from_jax``) and the same
``SyntheticLM`` batch (B 2 x S 64; token ids, or embeddings and M-RoPE
positions where the config takes them).  recurrentgemma-2b runs twice:
S 64 fits its window of 64, so its "W" layers take the global causal
route (``flash_attention``), and S 96 takes the local one.

The reference's loss and gradients come from ``jax.value_and_grad`` of
its ``make_loss_fn``, its updated parameters from its jitted
``make_train_step`` with AdamW; the port's from ``make_train_step``
(``remat="full"``) through ``recorded_step``, which keeps a copy of
the gradients the optimizer is handed.

Tolerances (float32): the loss within ``LOSS_TOL`` absolute, the
gradient norm within ``GRAD_TOL`` relative, every gradient leaf within
``GRAD_TOL`` in relative Frobenius norm (|g - g_ref| / |g_ref|; zero
where the reference's is, as for an embeddings config's token table), the
parameters after one AdamW step within ``PARAM_TOL`` absolute -
``tests/test_torch_train.py``'s float32 bounds.  Two leaves take
another bound, each with its reading and reason (``LEAF_TOL``,
``ZERO_GRAD``).  In the
MoE configs, the routing and the drop set of every layer equal the
reference's.

The same step's loss and gradients in bfloat16, and the counters of a
step under remat: ``test_torch_train_bf16.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_reduced as ref_get_reduced
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import Model as RefModel
from repro.train import optimizer as ref_opt
from repro.train.train_step import make_loss_fn as ref_make_loss_fn
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import recorded_step
from repro_torch.tree import Stacked, materialize
from test_torch_model_kinds import _kept, _ref_apply_routed

torch.set_num_threads(1)

B, S = 2, 64
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARAM_TOL = 1e-5
#: (arch, leaf) -> float32 bound, where GRAD_TOL does not hold:
LEAF_TOL = {
    # mamba2-370m's A_log: reads 1.16e-5.  Its gradient is 3.1e-6 in
    # norm, a millionth of the global norm: each element sums the SSD's
    # decay terms over every chunk and position, terms that cancel to a
    # small fraction of their size, so the fp32 roundings of the two
    # packages' summation orders show a few times more than elsewhere.
    ("mamba2-370m", "blocks/0/mamba/A_log"): 1e-4,
}
#: leaves whose gradient is zero in exact arithmetic, held absolutely:
#: |g| and |g_ref| at most ZERO_TOL of the global norm.  llama4's router
#: (top-1): the renormalised weight of a single expert is p / p = 1 for
#: any router output, so the loss does not depend on the router; both
#: packages read rounding noise (5.6e-10 and 4.1e-10 against a norm of
#: about 3), which a relative bound cannot compare.
ZERO_GRAD = {("llama4-maverick-400b-a17b", "blocks/0/moe/router")}
ZERO_TOL = 1e-8

CASES = [(arch, S) for arch in ARCH_NAMES] + [("recurrentgemma-2b", 96)]


def _np(x) -> np.ndarray:
    if isinstance(x, (torch.Tensor, Stacked)):
        return materialize(x).detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _twins(arch, dtype, seq):
    ref = RefModel(ref_get_reduced(arch).scaled(dtype=dtype))
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_jax(
        Model(get_reduced(arch).scaled(dtype=dtype), device="cpu"),
        jax.tree.map(np.asarray, params))
    cfg = ref.cfg
    data = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=B,
                embed_dim=cfg.d_model if cfg.input_mode == "embeddings"
                else 0, mrope=cfg.rope_kind == "mrope")
    rbatch = RefSyntheticLM(RefDataConfig(**data)).batch(0)
    pbatch = SyntheticLM(DataConfig(**data), device="cpu").batch(0)
    return ref, params, model, rbatch, pbatch


def _named(tree) -> list:
    """(path, float32 array) of the reference's leaves, in tree order."""
    return [(jax.tree_util.keystr(p, simple=True, separator="/"), _np(x))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _ref_grads(ref, params, batch):
    (loss, _), grads = jax.value_and_grad(ref_make_loss_fn(ref),
                                          has_aux=True)(params, batch)
    return float(loss), _named(grads)


def _kw():
    return dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("arch,seq", CASES)
def test_train_step_matches_reference(arch, seq, monkeypatch):
    ref, params, model, rbatch, pbatch = _twins(arch, "float32", seq)
    cfg = ref.cfg
    want_loss, want_grads = _ref_grads(ref, params, rbatch)
    ro = ref_opt.make_optimizer("adamw", **_kw())
    new_params, _, rm = jax.jit(ref_make_train_step(ref, ro))(
        params, ro.init(params), rbatch)

    got = recorded_step(model, opt.make_optimizer("adamw", **_kw()), pbatch)

    loss_err = abs(got["loss"] - want_loss)
    assert abs(float(rm["loss"]) - want_loss) <= LOSS_TOL["float32"]
    norm_err = abs(got["grad_norm"] - float(rm["grad_norm"])) / \
        float(rm["grad_norm"])
    errs = {}
    assert list(got["grads"]) == [name for name, _ in want_grads]
    for name, w in want_grads:
        g = got["grads"][name].numpy()
        assert g.shape == w.shape, name
        if not w.any():         # a table the loss does not read
            assert not g.any(), name
            continue
        if (arch, name) in ZERO_GRAD:
            scale = ZERO_TOL * float(rm["grad_norm"])
            assert np.linalg.norm(w) <= scale and np.linalg.norm(g) <= scale
            continue
        errs[name] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    worst = max(errs, key=errs.get)
    print(f"{arch} S {seq}: loss |diff| {loss_err:.3g}, norm relative "
          f"{norm_err:.3g}, worst leaf {worst} {errs[worst]:.3g}")
    assert loss_err <= LOSS_TOL["float32"]
    assert norm_err <= GRAD_TOL["float32"]
    for name, e in errs.items():
        assert e <= LEAF_TOL.get((arch, name), GRAD_TOL["float32"]), \
            (name, e)
    want_params = _named(new_params)
    assert list(got["params"]) == [name for name, _ in want_params]
    param_err = max(float(np.abs(got["params"][name].numpy() - w).max())
                    for name, w in want_params)
    assert param_err <= PARAM_TOL, param_err
    assert all(t.grad is None for t in model.parameters())

    if cfg.layer_pattern.count("W"):
        route = ("flash_attention:torch-cpu" if seq <= cfg.local_window
                 else "masked_blockwise:torch")
        assert got["op_paths"] == {route: cfg.layers.count("W")}
    if cfg.num_experts:
        _, want_routes = _ref_apply_routed(ref, params, rbatch, monkeypatch)
        assert len(got["routes"]) == len(want_routes) == cfg.layers.count("M")
        for e, (want, _) in zip(got["routes"], want_routes):
            np.testing.assert_array_equal(e.numpy(), np.asarray(want))
            np.testing.assert_array_equal(_kept(e.numpy(), cfg),
                                          _kept(want, cfg))
