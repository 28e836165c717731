"""A dense model trained across ranks (``train_step.make_rank_train_step``
through ``launch.train.train_on_rank``) against the JAX package's
sharded train step.

Reference side: one subprocess with 8 forced host devices runs, for each
job, the reference's ``jit(make_train_step(model, adamw))`` under
``set_activation_mesh(mesh)`` for two steps, the parameters placed by
``param_specs``, the moments by the dry run's ``_opt_specs`` and the
batch by ``batch_specs``, and ``jax.value_and_grad`` of its loss at step
1 for the gradients.  The jobs: reduced starcoder2-3b and phi4-mini-3.8b
in fp32 with ``attn_parallel`` "seq" and "head", remat "full", on (4, 2),
and starcoder2-3b "seq" on a (2, 2, 2) (pod, data, model) mesh; B 4 x S
64 (one row a data position on (4, 2), one a (pod, data) position on
(2, 2, 2)).  The weights are the reference's ``Model.init(PRNGKey(SEED))``,
drawn again in this process and converted by
``models.convert.params_from_jax``; the batches are ``SyntheticLM``'s
(seed 0) on both sides.

Port side, while the reference compiles: 8 gloo ranks on the CPU
(``ranks.launch``), each with its ``sharding.local_block`` of every leaf,
train every job for two AdamW steps with an RS(3, 2) EC copy of their
blocks (``tests/_train_rank_worker.py``).

Held, at ``tests/test_torch_train_archs.py``'s fp32 bounds: the loss
(``LOSS_TOL`` absolute) and the gradient norm (``GRAD_TOL`` relative) of
each step on every rank; each rank's step-1 gradient blocks
(``GRAD_TOL``, relative Frobenius); its parameter and moment blocks
after each step (``PARAM_TOL`` absolute).  Also: each rank's parity equal
to a fresh encode after each step; the bytes a rank's step sends by kind
equal to ``dryrun.count_rank_train`` at its coordinates; kernel 11's
route on every rank; a checkpoint the ranks wrote read by the
reference's ``restore_checkpoint``, and one the reference wrote read
into the ranks' blocks; a 1 x 1 mesh against the one-card
``make_train_step``, bit for bit; the striped attention backward against
autograd through ``flash_attention_plain(stripe=...)``; and the refusals.
"""
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _train_rank_worker
from conftest import subprocess_env
from repro.configs import get_reduced as ref_get_reduced
from repro.models import Model as RefModel
from repro.train import checkpoint as ref_ckpt
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import ranks, sharding
from repro_torch.distributed.ranks import counting_comms
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_plain)
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import Model, ranked
from repro_torch.models.convert import param_tree, params_from_jax
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_rank_train_step, make_train_step
from repro_torch.tree import leaves_with_path, path_str, tree_map
from test_torch_train_archs import GRAD_TOL, LOSS_TOL, PARAM_TOL

torch.set_num_threads(1)

ARCHS = ("starcoder2-3b", "phi4-mini-3.8b")
MODES = ("seq", "head")
MESH = (4, 2)
POD_MESH = (2, 2, 2)
JOBS = [f"{a}/{m}" for a in ARCHS for m in MODES]
POD_JOBS = ["starcoder2-3b/seq/pod"]
B, S = 4, 64
STEPS = 2
SEED = 25
CKPT_STEP = 3
DEADLINE = 300.0

REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_reduced
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.distributed import sharding as shd
from repro.launch.dryrun import _opt_specs
from repro.launch.mesh import make_mesh
from repro.models import Model, set_activation_mesh
from repro.train.optimizer import make_optimizer
from repro.train.train_step import make_loss_fn, make_train_step

def named(mesh, t):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                        is_leaf=lambda x: isinstance(x, P))

def flat(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}

out = {}
for job in JOBS + POD_JOBS:
    arch, mode = job.split("/")[:2]
    mesh = (make_mesh(POD_MESH, ("pod", "data", "model"))
            if job.endswith("/pod") else make_mesh(MESH, ("data", "model")))
    set_activation_mesh(mesh)
    cfg = get_reduced(arch).scaled(dtype="float32", attn_parallel=mode,
                                   remat="full")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(SEED))
    opt = make_optimizer("adamw", **OPT)
    state = opt.init(params)
    pspecs = shd.param_specs(cfg, params, mesh)
    params = jax.device_put(params, named(mesh, pspecs))
    state = jax.device_put(state, named(mesh, _opt_specs(
        jax.eval_shape(lambda: state), pspecs, mesh)))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    with mesh:
        step = jax.jit(make_train_step(model, opt))
        grad = jax.jit(jax.value_and_grad(make_loss_fn(model), has_aux=True))
        for i in range(STEPS):
            batch = data.batch(i)
            batch = jax.device_put(batch, named(mesh, shd.batch_specs(
                cfg, batch, mesh)))
            if i == 0:
                (loss, _), grads = grad(params, batch)
                out[f"{job}/grad_loss"] = np.asarray(loss)
                for k, v in flat(grads).items():
                    out[f"{job}/grads/{k}"] = v
            params, state, metrics = step(params, state, batch)
            out[f"{job}/{i}/loss"] = np.asarray(metrics["loss"])
            out[f"{job}/{i}/grad_norm"] = np.asarray(metrics["grad_norm"])
            for part, tree in (("params", params), ("m", state["m"]),
                               ("v", state["v"])):
                for k, v in flat(tree).items():
                    out[f"{job}/{i}/{part}/{k}"] = v
    set_activation_mesh(None)
np.savez(sys.argv[1], **out)
"""


def _cfg(arch, mode="seq"):
    return get_reduced(arch).scaled(dtype="float32", attn_parallel=mode,
                                    remat="full")


def _ref_params(arch):
    ref_cfg = ref_get_reduced(arch).scaled(dtype="float32")
    return RefModel(ref_cfg).init(jax.random.PRNGKey(SEED))


def _port_model(arch, mode="seq") -> Model:
    """The reference's ``Model.init(PRNGKey(SEED))`` in the port's model."""
    tree = jax.tree.map(np.asarray, _ref_params(arch))
    return params_from_jax(Model(_cfg(arch, mode), device="cpu"), tree)


def _blocks(model: Model, mesh, coords) -> dict:
    params = param_tree(model)
    specs = sharding.param_specs(model.cfg, params, mesh)
    return tree_map(lambda leaf, spec: sharding.local_block(
        leaf, spec, mesh, coords), params, specs)


def _specs_by_name(cfg, mesh) -> dict:
    with dispatch.dry_run():
        model = Model(cfg, device="meta")
    specs = sharding.param_specs(cfg, param_tree(model), mesh)
    return {path_str(k): v for k, v in leaves_with_path(specs)}


def _cut(arr, spec, mesh, coords) -> np.ndarray:
    """The block of a whole reference array at ``coords``."""
    t = torch.from_numpy(np.array(arr))
    return sharding.local_block(t, spec, mesh, coords).numpy()


def _mesh_of(job):
    if job.endswith("/pod"):
        return make_mesh(POD_MESH, ("pod", "data", "model"))
    return make_mesh(MESH, ("data", "model"))


def _ref_checkpoint(d) -> dict:
    """A reference-written checkpoint of the first job's parameters and a
    non-zero AdamW state; returns its arrays by tree path."""
    params = _ref_params(ARCHS[0])
    state = {"p": params, "o": {
        "m": jax.tree.map(lambda x: 0.5 * x, params),
        "v": jax.tree.map(lambda x: x * x, params),
        "count": jax.numpy.int32(CKPT_STEP)}}
    ref_ckpt.save_checkpoint(d, CKPT_STEP, state)
    return state


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the ranks' results by rank, the reference's outputs, the directory
    of the ranks' checkpoint, the reference's checkpoint state)."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    env = subprocess_env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    code = (f"JOBS = {JOBS!r}\nPOD_JOBS = {POD_JOBS!r}\nMESH = {MESH!r}\n"
            f"POD_MESH = {POD_MESH!r}\nB, S, STEPS, SEED = {B}, {S}, "
            f"{STEPS}, {SEED}\nOPT = {_train_rank_worker.OPT!r}\n"
            + textwrap.dedent(REFERENCE))
    proc = subprocess.Popen([sys.executable, "-c", code,
                             str(tmp / "ref.npz")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        mesh, pod_mesh = _mesh_of(JOBS[0]), _mesh_of(POD_JOBS[0])
        models = {job: _port_model(*job.split("/")[:2])
                  for job in JOBS + POD_JOBS}
        ref_state = _ref_checkpoint(str(tmp / "ref_ckpt"))
        args = []
        for r in range(mesh.size):
            jobs = [(job, models[job].cfg, _blocks(models[job], mesh,
                                                   mesh.coords(r)))
                    for job in JOBS]
            pod_jobs = [(job, models[job].cfg, _blocks(
                models[job], pod_mesh, pod_mesh.coords(r)))
                for job in POD_JOBS]
            args.append((jobs, pod_mesh, pod_jobs, B, S, STEPS,
                         str(tmp / "rank_ckpt"),
                         (str(tmp / "ref_ckpt"), CKPT_STEP, jobs[0][2])))
        res = ranks.launch(_train_rank_worker.train_body, mesh, args,
                           init_file=str(tmp / "init"), timeout=DEADLINE)
        _, err = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with np.load(tmp / "ref.npz") as f:
        ref = dict(f)
    return res, ref, str(tmp / "rank_ckpt"), ref_state


@pytest.mark.parametrize("job", JOBS + POD_JOBS)
def test_loss_and_norm_match_reference(both, job):
    """Every rank reports the reference's loss and global gradient norm at
    each step."""
    res, ref, _, _ = both
    assert abs(float(ref[f"{job}/grad_loss"]) - float(ref[f"{job}/0/loss"])) \
        <= LOSS_TOL["float32"]
    for r in res:
        for i, got in enumerate(r[job]["steps"]):
            assert abs(got["loss"] - float(ref[f"{job}/{i}/loss"])) <= \
                LOSS_TOL["float32"], (r[job]["coords"], i)
            want = float(ref[f"{job}/{i}/grad_norm"])
            assert abs(got["grad_norm"] - want) / want <= \
                GRAD_TOL["float32"], (r[job]["coords"], i)


@pytest.mark.parametrize("job", JOBS + POD_JOBS)
def test_gradient_blocks_match_reference(both, job):
    """Each rank's step-1 gradient blocks are the same blocks of
    ``jax.value_and_grad``'s gradients."""
    res, ref, _, _ = both
    mesh = _mesh_of(job)
    specs = _specs_by_name(_cfg(*job.split("/")[:2]), mesh)
    for r in res:
        got = r[job]
        assert list(got["grads"]) == list(specs)
        for name, g in got["grads"].items():
            want = _cut(ref[f"{job}/grads/{name}"], specs[name], mesh,
                        got["coords"])
            err = np.linalg.norm(g - want) / np.linalg.norm(want)
            assert err <= GRAD_TOL["float32"], (got["coords"], name, err)


@pytest.mark.parametrize("job", JOBS + POD_JOBS)
def test_parameter_and_moment_blocks_match_reference(both, job):
    """After each AdamW step, each rank's parameter blocks and its moment
    blocks (the reference's ``_opt_specs`` places moments as their
    parameters) are the reference's."""
    res, ref, _, _ = both
    mesh = _mesh_of(job)
    specs = _specs_by_name(_cfg(*job.split("/")[:2]), mesh)
    for r in res:
        got = r[job]
        for i, st in enumerate(got["steps"]):
            for part in ("params", "m", "v"):
                for name, x in st[part].items():
                    want = _cut(ref[f"{job}/{i}/{part}/{name}"], specs[name],
                                mesh, got["coords"])
                    err = float(np.abs(x - want).max())
                    assert err <= PARAM_TOL, (got["coords"], i, part, name,
                                              err)


@pytest.mark.parametrize("job", JOBS + POD_JOBS)
def test_parity_fresh_and_routes(both, job):
    """After each step every rank's parity equals a fresh encode of its
    new blocks; attention went through kernel 11's route (its plain
    version on the CPU), never the masked one."""
    res, _, _, _ = both
    cfg = _cfg(*job.split("/")[:2])
    for r in res:
        got = r[job]
        assert [st["stale"] for st in got["steps"]] == [0] * STEPS
        assert got["op_paths"] == {"flash_attention": dispatch.TORCH_CPU}
        assert got["routes"]["flash_attention:torch-cpu"] == \
            cfg.num_layers * STEPS
        assert not any(k.startswith("masked") for k in got["routes"])


@pytest.mark.parametrize("job", JOBS + POD_JOBS)
def test_sent_bytes_equal_dry_run_count(both, job):
    """A step's bytes sent by kind on each rank equal
    ``dryrun.count_rank_train``'s count of the same step at its
    coordinates: the gathers (forward and remat recompute), the gradients'
    reduce-scatters, the all-reduces and the EC update's permutes."""
    res, _, _, _ = both
    for r in res:
        got = r[job]
        assert got["sent"] == got["counted"], got["coords"]
        assert set(got["sent"]) == {"all-gather", "reduce-scatter",
                                    "all-reduce", "collective-permute"}


def test_rank_checkpoint_reads_in_the_reference(both):
    """The checkpoint the ranks wrote after the first job's last step
    (whole leaves, gathered, written by rank 0) restores in the
    reference's ``restore_checkpoint`` to the reference's own state after
    that step."""
    _, ref, rank_dir, _ = both
    job = JOBS[0]
    params = _ref_params(job.split("/")[0])
    like = {"p": params, "o": {
        "m": params, "v": params, "count": jax.numpy.int32(0)}}
    state = ref_ckpt.restore_checkpoint(rank_dir, STEPS, like)
    assert int(state["o"]["count"]) == STEPS
    for part, tree in (("params", state["p"]), ("m", state["o"]["m"]),
                       ("v", state["o"]["v"])):
        for p, x in jax.tree_util.tree_leaves_with_path(tree):
            name = jax.tree_util.keystr(p, simple=True, separator="/")
            want = ref[f"{job}/{STEPS - 1}/{part}/{name}"]
            assert np.abs(np.asarray(x) - want).max() <= PARAM_TOL, name


def test_reference_checkpoint_reads_into_rank_blocks(both):
    """A checkpoint the reference wrote restores into each rank's blocks:
    each is the ``local_block`` of the saved leaf, exactly."""
    res, _, _, ref_state = both
    mesh = _mesh_of(JOBS[0])
    specs = _specs_by_name(_cfg(ARCHS[0]), mesh)
    whole = {}
    for part, tree in (("p", ref_state["p"]), ("m", ref_state["o"]["m"]),
                       ("v", ref_state["o"]["v"])):
        whole[part] = {jax.tree_util.keystr(p, simple=True, separator="/"):
                       np.asarray(x) for p, x in
                       jax.tree_util.tree_leaves_with_path(tree)}
    for r in res:
        got = r["restored"]
        coords = r[JOBS[0]]["coords"]
        assert got["count"] == CKPT_STEP
        for part in ("p", "m", "v"):
            for name, x in got[part].items():
                np.testing.assert_array_equal(
                    x, _cut(whole[part][name], specs[name], mesh, coords))


def test_one_by_one_mesh_is_the_one_card_step():
    """On a 1 x 1 mesh ``train_on_rank`` is ``make_train_step`` on one
    card: two AdamW steps' losses, norms and parameters bit for bit."""
    model = _port_model(ARCHS[0])
    twin = _port_model(ARCHS[0])
    mesh = make_host_mesh()
    norms = []
    losses = launch_train.train_on_rank(
        counting_comms(mesh, (0, 0)), model.cfg,
        _blocks(model, mesh, (0, 0)), steps=STEPS, batch=B, seq=S,
        device="cpu", observe=lambda i, st: norms.append(
            float(st["metrics"]["grad_norm"])), log=lambda *a: None)
    opt = make_optimizer("adamw", lr=1e-3,
                         warmup_steps=min(20, STEPS // 5 + 1),
                         total_steps=STEPS)
    params = param_tree(twin)
    state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab_size=twin.cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0), device="cpu")
    step = make_train_step(twin, opt)
    for i in range(STEPS):
        _, state, m = step(params, state, data.batch(i))
        assert losses[i] == float(m["loss"])
        assert norms[i] == float(m["grad_norm"])
    for (_, a), (_, b) in zip(model.named_parameters(),
                              twin.named_parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stripe,Sq,Skv", [
    ((16, 2, 0), 48, 96), ((16, 2, 1), 48, 96), ((32, 2, 1), 64, 80),
    ((8, 4, 3), 40, 100)])
def test_striped_backward_matches_plain_autograd(stripe, Sq, Skv):
    """``flash_attention``'s backward on a stripe's rows (a tile whose
    last position passes Skv included) equals autograd through
    ``flash_attention_plain`` with the same stripe; a stripe count of 1
    is the unstriped backward, bit for bit."""
    g = torch.Generator().manual_seed(SEED)
    q = torch.randn((2, Sq, 4, 16), generator=g)
    k, v = (torch.randn((2, Skv, 2, 16), generator=g) for _ in range(2))
    w = torch.randn((2, Sq, 4, 16), generator=g)
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        (fn(qs, ks, vs, stripe=stripe) * w).sum().backward()
        grads.append((qs.grad, ks.grad, vs.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    out = flash_attention_plain(q, k, v)
    one = flash_attention_backward(q, k, v, out, w, stripe=(stripe[0], 1, 0))
    none = flash_attention_backward(q, k, v, out, w)
    for a, b in zip(one, none):
        assert torch.equal(a, b)


def test_init_blocks_are_the_models_weights():
    """``ranked.init_blocks`` draws, module by module, the blocks of
    ``Model(cfg).init(generator)`` at a position, exactly."""
    cfg = _cfg(ARCHS[1])
    mesh = make_mesh(POD_MESH, ("pod", "data", "model"))
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for coords in ((0, 1, 0), (1, 0, 1)):
        got = ranked.init_blocks(cfg, mesh, coords,
                                 torch.Generator().manual_seed(3))
        want = _blocks(model, mesh, coords)
        for (p, a), (_, b) in zip(leaves_with_path(got),
                                  leaves_with_path(want)):
            for x, y in zip(getattr(a, "parts", [a]), getattr(b, "parts",
                                                              [b])):
                assert torch.equal(x, y), path_str(p)


def test_pod_axis_moves_nothing_in_the_forward():
    """On the (2, 2, 2) mesh a rank's forward sends, by kind, what a rank
    of the (2, 2) mesh sends for its share of half the batch: the pod
    axis carries no bytes; its train step adds the gradients' all-reduce
    over the pods."""
    cfg = _cfg(ARCHS[0])
    pods = make_mesh(POD_MESH, ("pod", "data", "model"))
    flat = make_mesh(POD_MESH[1:], ("data", "model"))
    with dispatch.dry_run():
        for a in range(2):
            for m in range(2):
                for p in range(2):
                    got = dryrun.count_rank_forward(
                        cfg, ShapeSpec("x", "prefill", S, B), pods,
                        (p, a, m))
                    want = dryrun.count_rank_forward(
                        cfg, ShapeSpec("x", "prefill", S, B // 2), flat,
                        (a, m))
                    assert got["collectives"] == want["collectives"]
        got = dryrun.count_rank_train(cfg, ShapeSpec("x", "train", S, B),
                                      pods, (0, 0, 0))
        want = dryrun.count_rank_train(cfg, ShapeSpec("x", "train", S,
                                                      B // 2), flat, (0, 0))
    assert got["collectives"]["all-reduce"] > \
        want["collectives"]["all-reduce"]
    for kind in ("all-gather", "reduce-scatter"):
        assert got["collectives"][kind] == want["collectives"][kind]


def test_batch_rows_shrink_over_pods():
    """``shard_act``'s "batch" on (pod, data): P·A row blocks, pod major;
    the axes shrink to ("data",) below P·A rows and to nothing below A;
    each row's copies over the (pod, data) positions."""
    assert [ranked.batch_rows(8, 2, a, 2, p) for p in range(2)
            for a in range(2)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert [ranked.batch_rows(2, 2, a, 2, p) for p in range(2)
            for a in range(2)] == [(0, 1), (1, 2), (0, 1), (1, 2)]
    assert ranked.batch_rows(1, 2, 1, 2, 1) == (0, 1)
    assert [ranked.batch_copies(b, 2, 2) for b in (8, 2, 1)] == [1, 2, 4]
    with pytest.raises(ValueError, match="batch of 6 on 4"):
        ranked.batch_rows(6, 2, 0, 2, 0)


@pytest.mark.parametrize("name", ("adamw8bit", "adafactor"))
def test_other_optimizers_refuse_across_ranks(name):
    """adamw8bit and adafactor refuse a mesh larger than 1 x 1, naming
    their ROADMAP item; the 1 x 1 mesh takes them."""
    cfg = _cfg(ARCHS[0])
    mesh = make_mesh((2, 2), ("data", "model"))
    model = ranked.RankModel(cfg, {}, counting_comms(mesh, (0, 1)))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md Queue 1 item 13 "):
        make_rank_train_step(model, make_optimizer(name))
    one = ranked.RankModel(cfg, _blocks(_port_model(ARCHS[0]),
                                        make_host_mesh(), (0, 0)),
                           counting_comms(make_host_mesh(), (0, 0)))
    make_rank_train_step(one, make_optimizer(name))


@pytest.mark.parametrize("world", (None, "8"))
def test_production_mesh_refuses_outside_its_world(world, monkeypatch,
                                                   capsys):
    """``launch.train --mesh single`` outside a torch.distributed world of
    256 ranks refuses with the device count; ``--mesh multi`` names 512."""
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    for mesh, n in (("single", 256), ("multi", 512)):
        with pytest.raises(SystemExit):
            launch_train.main(["--arch", ARCHS[0], "--reduced", "--mesh",
                               mesh, "--device", "cpu"])
        assert f"({n} devices)" in capsys.readouterr().err


@pytest.mark.parametrize("arch,item", [
    ("minicpm3-4b", 8), ("llama4-maverick-400b-a17b", 7),
    ("mamba2-370m", 9), ("recurrentgemma-2b", 10)])
def test_other_kinds_refuse_to_train_across_ranks(arch, item):
    """Training another layer kind on a (2, 2) mesh raises, naming its
    ROADMAP item (the attention options train across ranks:
    ``tests/test_torch_serve_ranks.py``)."""
    mesh = make_mesh((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue 1 item {item} "):
        launch_train.train_on_rank(counting_comms(mesh, (1, 0)),
                                   get_reduced(arch), {}, steps=1,
                                   log=lambda *a: None)


def test_dry_run_counts_a_rank_train_cell():
    """With AdamW the dry run counts a dense train cell on a mesh as one
    rank's train step (``count_rank_train`` at every model position);
    with the CLI's adamw8bit it keeps the even split, naming the ROADMAP
    item that ports that optimizer across ranks."""
    saved = dryrun.get_config
    dryrun.get_config = get_reduced
    try:
        mesh = make_mesh((2, 2), ("data", "model"))
        res = dryrun.run_cell(ARCHS[0], "train_4k", mesh, optimizer="adamw",
                              batch=B, seq=S)
        even = dryrun.run_cell(ARCHS[0], "train_4k", mesh, batch=B, seq=S)
    finally:
        dryrun.get_config = saved
    assert res["count"] == "rank"
    assert sorted(tuple(p["coords"]) for p in res["positions"]) == \
        [(0, 0), (0, 1)]
    assert all(res["collectives"][k] > 0 for k in (
        "all-gather", "reduce-scatter", "all-reduce"))
    assert even["count"] == "even split"
    assert "Queue 1 item 13" in even["collective_note"]
