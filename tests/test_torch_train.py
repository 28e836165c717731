"""The port's training path against the JAX package's: the data pipeline,
the optimizers, the loss, the training step, disk checkpoints, the
training launcher and the example twins.

starcoder2-3b's reduced config runs in float32 and bfloat16 with the
reference's weights (``models.convert.params_from_jax``) and the same
synthetic batches.  Tolerances:

* ``SyntheticLM`` batches, checkpoint round trips: exact.
* The optimizers, from the same numpy gradients: updates within 1e-6 +
  1e-5 relative (fp32 arithmetic in the reference's order; the power and
  cosine of the schedule may differ in the last ulp between numpy and
  XLA); the 8-bit moments' int8 codes within 1 (a value on a rounding
  boundary).
* Loss and gradients of one step: float32 1e-5 (absolute on the loss,
  relative to each leaf's largest gradient); bfloat16 1e-3 on the loss
  and 2e-2 on the gradients (a few bf16 roundings, 2^-8 each, taken in
  another order).
* Four AdamW steps: losses as above; parameters float32 1e-5, bfloat16
  1e-2 - at step 1 Adam moves a parameter by about lr * sign(g), so a
  gradient element whose sign differs between the two packages moves
  it by 2 * lr = 2e-3 a step, 8e-3 over four, plus a bf16 rounding.
* ``launch.train --ec`` from the same checkpoint: losses within the
  bfloat16 bound above.
"""
import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch import train as ref_train
from repro.models import Model as RefModel
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train.train_step import cross_entropy as ref_cross_entropy
from repro.train.train_step import make_loss_fn as ref_make_loss_fn
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as port_train
from repro_torch.models import Model
from repro_torch.models.convert import param_tree, params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (cross_entropy, eval_step,
                                          make_loss_fn, make_train_step,
                                          value_and_grad)
from repro_torch.tree import Stacked, leaves, materialize

torch.set_num_threads(1)

ARCH = "starcoder2-3b"
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARAM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DATA = dict(seq_len=64, global_batch=4)


def _np(x) -> np.ndarray:
    """A reference array or a port leaf as float32 numpy."""
    if isinstance(x, (torch.Tensor, Stacked)):
        return materialize(x).detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _twins(dtype, seed=0):
    ref = RefModel(ref_get_reduced(ARCH).scaled(dtype=dtype))
    params = ref.init(jax.random.PRNGKey(seed))
    model = Model(get_reduced(ARCH).scaled(dtype=dtype), device="cpu")
    params_from_jax(model, jax.tree.map(np.asarray, params))
    return ref, params, model


def _batches(vocab):
    ref = RefSyntheticLM(RefDataConfig(vocab_size=vocab, **DATA))
    port = SyntheticLM(DataConfig(vocab_size=vocab, **DATA), device="cpu")
    return ref, port


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(embed_dim=16), dict(mrope=True),
                                dict(seed=3, zipf_a=1.1)])
def test_synthetic_batches_equal_reference(kw):
    cfg = dict(vocab_size=300, seq_len=24, global_batch=6, **kw)
    ref = RefSyntheticLM(RefDataConfig(**cfg))
    port = SyntheticLM(DataConfig(**cfg), device="cpu")
    for step, host, count in ((0, 0, 1), (7, 1, 2)):
        want = ref.batch(step, host, count)
        got = port.batch(step, host, count)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == getattr(torch, str(want[key].dtype))
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_synthetic_lm_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticLM(DataConfig(vocab_size=10, seq_len=4, global_batch=1))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _grad_trees(step, stacked):
    """Same gradients for both packages; the port's "w3" a ``Stacked``
    leaf when ``stacked`` (the reference's stacked array)."""
    rng = np.random.default_rng(step)
    arrays = {"b": rng.standard_normal(()).astype(np.float32),
              "w1": rng.standard_normal(700).astype(np.float32),
              "w2": rng.standard_normal((30, 20)).astype(np.float32),
              "w3": rng.standard_normal((3, 9, 5)).astype(np.float32)}
    port = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    if stacked:
        port["w3"] = Stacked(torch.from_numpy(v.copy()) for v in arrays["w3"])
    return {k: jnp.asarray(v) for k, v in arrays.items()}, port


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_optimizer_updates_match_reference(name, stacked):
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10)
    if name != "adafactor":
        kw["weight_decay"] = 0.1
    ref = ref_opt.make_optimizer(name, **kw)
    port = opt.make_optimizer(name, **kw)
    rp, pp = _grad_trees(100, stacked)
    rs, ps = ref.init(rp), port.init(pp)
    for step in range(3):
        rg, pg = _grad_trees(step, stacked)
        ru, rs = ref.update(rg, rs, rp)
        pu, ps = port.update(pg, ps, pp)
        for a, b in zip(jax.tree.leaves(ru), leaves(pu)):
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-6)
        rp = ref_opt.apply_updates(rp, ru)
        opt.apply_updates(pp, pu)
    assert int(ps["count"]) == int(rs["count"]) == 3
    for a, b in zip(jax.tree.leaves(rs), leaves(ps)):
        a, b = np.asarray(a), materialize(b).numpy()
        tol = 1 if a.dtype == np.int8 else 1e-5 * max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b.astype(np.float64), a, rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_optimizer_apply_equals_update_then_apply(name):
    """``apply`` (update and apply a tensor at a time, the gradient scale
    fused) gives what ``update`` + ``apply_updates`` of scaled gradients
    give."""
    kw = dict(lr=0.05, warmup_steps=1, total_steps=5)
    runs = []
    for fused in (False, True):
        o = opt.make_optimizer(name, **kw)
        _, params = _grad_trees(100, True)
        state = o.init(params)
        for step in range(2):
            _, g = _grad_trees(step, True)
            scale = torch.tensor(0.5)
            if fused:
                o.apply(g, state, params, scale)
            else:
                clipped = {k: (Stacked(t * scale for t in v.parts)
                               if isinstance(v, Stacked) else v * scale)
                           for k, v in g.items()}
                updates, state = o.update(clipped, state, params)
                opt.apply_updates(params, updates)
        runs.append([materialize(x).clone() for x in leaves(params)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(kind):
    ref = ref_opt.make_schedule(1e-3, 5, kind, 40)
    port = opt.make_schedule(1e-3, 5, kind, 40)
    for step in range(0, 45, 3):
        np.testing.assert_allclose(float(port(step)),
                                   float(ref(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    arrays = {"a": rng.standard_normal((20, 30)) * 3,
              "b": rng.standard_normal(50)}
    ref_tree = {k: jnp.asarray(v, dtype=dtype) for k, v in arrays.items()}
    port_tree = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        getattr(torch, dtype)) for k, v in arrays.items()}
    for max_norm in (1.0, 1e3):
        rc, rn = ref_opt.clip_by_global_norm(ref_tree, max_norm)
        pc, pn = opt.clip_by_global_norm(port_tree, max_norm)
        np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
        for k in arrays:
            assert pc[k].dtype == torch.float32
            np.testing.assert_allclose(_np(pc[k]), _np(rc[k]), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# loss, gradients, steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 64)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = ref_cross_entropy(jnp.asarray(logits, dtype=dtype),
                             jnp.asarray(labels))
    got = cross_entropy(torch.from_numpy(logits).to(getattr(torch, dtype)),
                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    ref, params, model = _twins(dtype)
    rb, pb = _batches(ref.cfg.vocab_size)
    (rl, _), rg = jax.value_and_grad(ref_make_loss_fn(ref), has_aux=True)(
        params, rb.batch(0))
    (pl, _), pg = value_and_grad(make_loss_fn(model), param_tree(model),
                                 pb.batch(0))
    assert abs(float(pl) - float(rl)) <= LOSS_TOL[dtype]
    ref_leaves = jax.tree.leaves(rg)
    assert len(ref_leaves) == len(leaves(pg))
    for a, b in zip(ref_leaves, leaves(pg)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL[dtype] * np.abs(a).max()
    assert abs(float(eval_step(model)(param_tree(model), pb.batch(0)))
               - float(pl)) <= LOSS_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_reference(dtype):
    ref, params, model = _twins(dtype)
    rb, pb = _batches(ref.cfg.vocab_size)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    ro = ref_opt.make_optimizer("adamw", **kw)
    po = opt.make_optimizer("adamw", **kw)
    rstate = ro.init(params)
    pparams = param_tree(model)
    pstate = po.init(pparams)
    rstep = jax.jit(ref_make_train_step(ref, ro))
    pstep = make_train_step(model, po)
    for i in range(4):
        params, rstate, rm = rstep(params, rstate, rb.batch(i))
        _, pstate, pm = pstep(pparams, pstate, pb.batch(i))
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= LOSS_TOL[dtype]
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= \
            GRAD_TOL[dtype] * float(rm["grad_norm"])
    for a, b in zip(jax.tree.leaves(params), leaves(pparams)):
        assert np.abs(_np(a) - _np(b)).max() <= PARAM_TOL[dtype]
    assert all(t.grad is None for t in model.parameters())


def test_remat_modes_give_the_same_gradients():
    grads = []
    for remat in ("full", "dots", "none"):
        cfg = get_reduced(ARCH).scaled(dtype="float32", remat=remat)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        _, pb = _batches(cfg.vocab_size)
        _, g = value_and_grad(make_loss_fn(model), param_tree(model),
                              pb.batch(0))
        grads.append([_np(x) for x in leaves(g)])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_serving_apply_stays_without_gradients():
    _, _, model = _twins("float32")
    _, pb = _batches(model.cfg.vocab_size)
    value_and_grad(make_loss_fn(model), param_tree(model), pb.batch(0))
    assert not model.apply(pb.batch(0)).requires_grad


# ---------------------------------------------------------------------------
# disk checkpoints
# ---------------------------------------------------------------------------

def _state(dtype="bfloat16"):
    ref, params, model = _twins(dtype, seed=2)
    ro = ref_opt.make_optimizer("adamw", lr=1e-3, total_steps=5)
    rb, pb = _batches(ref.cfg.vocab_size)
    rparams, rstate, _ = jax.jit(ref_make_train_step(ref, ro))(
        params, ro.init(params), rb.batch(0))
    return ref, {"p": rparams, "o": rstate}, model


def _port_like(model):
    params = param_tree(model)
    return {"p": params,
            "o": opt.make_optimizer("adamw").init(params)}


def _assert_trees_equal(ref_tree, port_tree):
    ref_leaves = jax.tree.leaves(ref_tree)
    assert len(ref_leaves) == len(leaves(port_tree))
    for a, b in zip(ref_leaves, leaves(port_tree)):
        a = np.asarray(a)
        b = materialize(b)
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    _, tree, model = _state()
    ref_ckpt.save_checkpoint(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    port = ckpt.restore_checkpoint(str(tmp_path), 7, _port_like(model))
    _assert_trees_equal(tree, port)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    _, tree, model = _state()
    port = _port_like(model)
    ckpt.restore_checkpoint(*_saved(tmp_path / "a", tree), port)
    ckpt.save_checkpoint(str(tmp_path / "b"), 3, port)
    names = [m["name"] for m in _manifest(tmp_path / "b", 3)]
    assert names == [m["name"] for m in _manifest(tmp_path / "a", 1)]
    back = ref_ckpt.restore_checkpoint(str(tmp_path / "b"), 3, tree)
    _assert_trees_equal(back, port)


def _saved(path, tree):
    ref_ckpt.save_checkpoint(str(path), 1, tree)
    return str(path), 1


def _manifest(path, step):
    import json
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)["leaves"]


def test_checkpoint_gc_keeps_the_last(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.zeros((), dtype=torch.int32)}
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), step, tree, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    like = {"a": torch.zeros(2, 3), "b": torch.ones((), dtype=torch.int32)}
    ckpt.restore_checkpoint(str(tmp_path), 4, like)
    assert torch.equal(like["a"], tree["a"]) and int(like["b"]) == 0
    assert ckpt.latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# launcher and examples
# ---------------------------------------------------------------------------

def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


@pytest.mark.parametrize("arch", [ARCH, "recurrentgemma-2b", "mamba2-370m",
                                  "kimi-k2-1t-a32b"])
def test_launch_train_matches_reference_from_one_checkpoint(tmp_path, arch):
    """Both launchers resume from the same step-0 checkpoint (the
    reference's weights and optimizer state) and train four steps with an
    EC checkpoint; their losses agree."""
    cfg = ref_get_reduced(arch)
    params = RefModel(cfg).init(jax.random.PRNGKey(5))
    ro = ref_opt.make_optimizer("adamw", lr=1e-3, warmup_steps=1,
                                total_steps=4)
    for d in ("ref", "port"):
        ref_ckpt.save_checkpoint(str(tmp_path / d), 0,
                                 {"p": params, "o": ro.init(params)})
    args = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "32", "--ec", "--log-every", "1"]
    want, _ = _quiet(ref_train.main, args + ["--ckpt-dir",
                                             str(tmp_path / "ref")])
    got, text = _quiet(port_train.main, args + [
        "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert "resumed from step 0" in text and "RS(3,2)" in text
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL["bfloat16"])


def test_launch_train_saves_checkpoints_and_loss_falls(tmp_path):
    losses, text = _quiet(port_train.main, [
        "--arch", ARCH, "--reduced", "--steps", "20", "--batch", "4",
        "--seq", "32", "--device", "cpu", "--ec", "--ckpt-dir",
        str(tmp_path), "--ckpt-every", "10"])
    assert losses[-1] < losses[0] - 0.3
    assert ckpt.latest_step(str(tmp_path)) == 20
    assert "final loss" in text


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_launch_train_refuses_the_production_mesh(mesh, capsys):
    with pytest.raises(SystemExit):
        port_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--mesh", mesh])
    assert "one card" in capsys.readouterr().err


def test_example_train_ec_checkpoint_runs_on_the_cpu():
    from repro_torch.examples import train_ec_checkpoint
    losses, text = _quiet(train_ec_checkpoint.main,
                          ["--steps", "12", "--device", "cpu"])
    assert "reconstructed shard matches live state: True" in text
    assert losses[-1] < losses[0]


def test_example_serve_degraded_runs_on_the_cpu():
    from repro_torch.examples import serve_degraded
    ok, text = _quiet(serve_degraded.main, ["--device", "cpu"])
    assert ok and "match live cache: True" in text
