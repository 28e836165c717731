"""A model trained across ranks (``train_step.make_rank_train_step``
through ``launch.train.train_on_rank``) against the JAX package's
sharded train step.

Reference side: three subprocesses with 8 forced host devices each
(AdamW's jobs in one, the other optimizers' in two halves, compiling
side by side) run, for each job, the reference's
``jit(make_train_step(model, opt))`` under ``set_activation_mesh(mesh)``
for two steps, the parameters placed by ``param_specs``, the optimizer
state by the dry run's ``_opt_specs`` and the batch by ``batch_specs``,
and ``jax.value_and_grad`` of its loss at step 1 for the gradients.  The
jobs ("arch/mode[/optimizer][/pod]"): reduced starcoder2-3b and
phi4-mini-3.8b in fp32 with ``attn_parallel`` "seq" and "head", remat
"full", AdamW, on (4, 2); starcoder2-3b with adamw8bit and with
adafactor, recurrentgemma-2b (RG-LRU and "W" layers) with adamw8bit,
mamba2-370m (Mamba-2) with adafactor and minicpm3-4b (MLA: its latent
attention striped over "model") with AdamW and with adamw8bit, and with
3 heads ("minicpm3-h3": head leaves whole on every model position,
``wo`` split by flat rows across a head) with AdamW,
llama4-maverick-400b-a17b (MoE, top-1, "seq") with AdamW and
kimi-k2-1t-a32b (MoE, top-4, its heads on the "head" path) with AdamW,
adamw8bit and adafactor on (4, 2); and starcoder2-3b (AdamW),
mamba2-370m (adafactor), both MoE archs (AdamW) and minicpm3-h3
(adafactor) on a (2, 2, 2) (pod, data, model) mesh; B 4 x S 64 (one row
a data position on (4, 2), one a (pod, data) position on (2, 2, 2)).  The weights are the reference's
``Model.init(PRNGKey(SEED))``, drawn again in this process and converted
by ``models.convert.params_from_jax``; the batches are ``SyntheticLM``'s
(seed 0) on both sides.

Port side, while the reference compiles: 8 gloo ranks on the CPU
(``ranks.launch``), each with its ``sharding.local_block`` of every leaf,
train every job for two steps with an RS(3, 2) EC copy of their blocks
(``tests/_train_rank_worker.py``).

Held, at ``tests/test_torch_train_archs.py``'s fp32 bounds: the loss
(``LOSS_TOL`` absolute) and the gradient norm (``GRAD_TOL`` relative) of
each step on every rank; each rank's step-1 gradient blocks
(``GRAD_TOL``, relative Frobenius; Mamba-2's ``A_log`` at its
``LEAF_TOL``); its parameter blocks after each step (``PARAM_TOL``
absolute; an adamw8bit job's step 2 as
``test_parameter_and_moment_blocks_match_reference`` states); AdamW's
moment blocks, and adamw8bit's and adafactor's replicated state, the
same on every rank and the reference's (int8 codes within 1, the rest
within ``PARAM_TOL`` of the leaf's largest value).  Also: each rank's
parity equal to a fresh encode after each step; the bytes a rank's step
sends by kind equal to ``dryrun.count_rank_train`` at its coordinates,
and the dry run's adamw8bit training cell equal to a rank's sends;
kernel 11's route on every rank; checkpoints the ranks wrote (AdamW's
moments by block, adamw8bit's state once, whole) read by the
reference's ``restore_checkpoint``, and one the reference wrote read
into the ranks' blocks; a 1 x 1 mesh against the one-card
``make_train_step``, bit for bit; each optimizer on four ranks' blocks
against the one-card optimizer on the same gradients; the striped
attention backward against autograd through
``flash_attention_plain(stripe=...)``; and an expert count the model
axis does not divide raising.
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
from repro.train import optimizer as ref_opt
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
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import Stacked, leaves_with_path, path_str, tree_map
from test_torch_model_ranks import VARIANTS
from test_torch_train_archs import (GRAD_TOL, LEAF_TOL, LOSS_TOL, PARAM_TOL,
                                    ZERO_GRAD, ZERO_TOL)

torch.set_num_threads(1)

ARCHS = ("starcoder2-3b", "phi4-mini-3.8b")
MODES = ("seq", "head")
MESH = (4, 2)
POD_MESH = (2, 2, 2)
#: a job is "arch/mode[/optimizer][/pod]" (AdamW unless named)
JOBS = [f"{a}/{m}" for a in ARCHS for m in MODES] + [
    "starcoder2-3b/seq/adamw8bit", "starcoder2-3b/seq/adafactor",
    "recurrentgemma-2b/seq/adamw8bit", "mamba2-370m/seq/adafactor",
    "minicpm3-4b/seq", "minicpm3-4b/seq/adamw8bit", "minicpm3-h3/seq",
    "llama4-maverick-400b-a17b/seq", "kimi-k2-1t-a32b/auto",
    "kimi-k2-1t-a32b/auto/adamw8bit", "kimi-k2-1t-a32b/auto/adafactor"]
POD_JOBS = ["starcoder2-3b/seq/pod", "mamba2-370m/seq/adafactor/pod",
            "llama4-maverick-400b-a17b/seq/pod", "kimi-k2-1t-a32b/auto/pod",
            "minicpm3-h3/seq/adafactor/pod"]
#: the jobs whose ranks write a disk checkpoint after their last step
SAVES = (JOBS[0], "starcoder2-3b/seq/adamw8bit")
#: the job whose step-2 sends the dry run's training cell of the same
#: config and optimizer (the CLI's default) is held to
CELL_JOB = "recurrentgemma-2b/seq/adamw8bit"
B, S = 4, 64
STEPS = 2
SEED = 25
CKPT_STEP = 3
#: the share of an adamw8bit job's elements whose step-1 moment codes
#: may move by one against the reference's
CODE_FLIPS = 1e-3
#: the relative bound of an adamw8bit step-2 update whose step-1 v code
#: is 0 (``test_parameter_and_moment_blocks_match_reference``)
V0_REL = 0.1
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
    name = next((p for p in job.split("/")[2:] if p != "pod"), "adamw")
    mesh = (make_mesh(POD_MESH, ("pod", "data", "model"))
            if job.endswith("/pod") else make_mesh(MESH, ("data", "model")))
    set_activation_mesh(mesh)
    base, extra = VARIANTS.get(arch, (arch, {}))
    cfg = get_reduced(base).scaled(dtype="float32", attn_parallel=mode,
                                   remat="full", **extra)
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(SEED))
    opt = make_optimizer(name, **OPT)
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
            trees = [("params", params)] + [
                (part, tree) for part, tree in state.items()
                if part != "count"]
            for part, tree in trees:
                for k, v in flat(tree).items():
                    out[f"{job}/{i}/{part}/{k}"] = v
    set_activation_mesh(None)
np.savez(sys.argv[1], **out)
"""


def _cfg(arch, mode="seq"):
    base, extra = VARIANTS.get(arch, (arch, {}))
    return get_reduced(base).scaled(dtype="float32", attn_parallel=mode,
                                    remat="full", **extra)


def _ref_params(arch):
    base, extra = VARIANTS.get(arch, (arch, {}))
    ref_cfg = ref_get_reduced(base).scaled(dtype="float32", **extra)
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
    procs = []
    # three reference processes compile side by side: AdamW's jobs, and
    # the other optimizers' (slower to compile) in two halves
    others = [j for j in JOBS + POD_JOBS if _opt_name(j) != "adamw"]
    groups = [[j for j in JOBS + POD_JOBS if _opt_name(j) == "adamw"],
              others[::2], others[1::2]]
    for i, group in enumerate(groups):
        jobs = [j for j in group if j in JOBS]
        pods = [j for j in group if j in POD_JOBS]
        code = (f"JOBS = {jobs!r}\nPOD_JOBS = {pods!r}\nMESH = {MESH!r}\n"
                f"VARIANTS = {VARIANTS!r}\n"
                f"POD_MESH = {POD_MESH!r}\nB, S, STEPS, SEED = {B}, {S}, "
                f"{STEPS}, {SEED}\nOPT = {_train_rank_worker.OPT!r}\n"
                + textwrap.dedent(REFERENCE))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / f"ref{i}.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        mesh, pod_mesh = _mesh_of(JOBS[0]), _mesh_of(POD_JOBS[0])
        models = {job: _port_model(*job.split("/")[:2])
                  for job in JOBS + POD_JOBS}
        ref_state = _ref_checkpoint(str(tmp / "ref_ckpt"))
        saves = {job: str(tmp / f"rank_ckpt{i}")
                 for i, job in enumerate(SAVES)}
        args = []
        for r in range(mesh.size):
            jobs = [(job, models[job].cfg, _blocks(models[job], mesh,
                                                   mesh.coords(r)))
                    for job in JOBS]
            pod_jobs = [(job, models[job].cfg, _blocks(
                models[job], pod_mesh, pod_mesh.coords(r)))
                for job in POD_JOBS]
            args.append((jobs, pod_mesh, pod_jobs, B, S, STEPS, saves,
                         (str(tmp / "ref_ckpt"), CKPT_STEP, jobs[0][2])))
        res = ranks.launch(_train_rank_worker.train_body, mesh, args,
                           init_file=str(tmp / "init"), timeout=DEADLINE)
        errs = [proc.communicate(timeout=DEADLINE)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = {}
    for i, (proc, err) in enumerate(zip(procs, errs)):
        assert proc.returncode == 0, err[-4000:]
        with np.load(tmp / f"ref{i}.npz") as f:
            ref.update(f)
    return res, ref, saves, ref_state


def _arch(job) -> str:
    return job.split("/")[0]


def _opt_name(job) -> str:
    return _train_rank_worker._optimizer(job)


def _grad_bound(job, name) -> float:
    return LEAF_TOL.get((_arch(job), name), GRAD_TOL["float32"])


def _moment_codes(job, got, ref, name, spec, mesh, coords):
    """For an adamw8bit job: a mask of the block's elements whose step-1
    moment codes (m and v) are the reference's, the number of the leaf's
    elements whose codes moved, and the block's step-1 v codes (None for
    another optimizer).  An element whose code moved by one (a rounding
    at the quantizer's half step) steps differently in step 2; only
    such elements are left out of the step-2 comparison."""
    if _opt_name(job) != "adamw8bit":
        return None, 0, None
    agree = None
    for part in ("m", "v"):
        mine = got["steps"][0]["state"][part][f"{name}/q"]
        want = ref[f"{job}/0/{part}/{name}/q"]
        same = (mine == want).reshape(-1)
        agree = same if agree is None else agree & same
    shape = ref[f"{job}/0/params/{name}"].shape
    n = int(np.prod(shape))
    whole = agree[:n].reshape(shape)
    vq = ref[f"{job}/0/v/{name}/q"].reshape(-1)[:n].reshape(shape)
    return (_cut(whole, spec, mesh, coords), int((~whole).sum()),
            _cut(vq, spec, mesh, coords))


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
    ``jax.value_and_grad``'s gradients (Mamba-2's ``A_log`` at its stated
    bound, ``test_torch_train_archs.LEAF_TOL``; llama4-maverick's top-1
    router, zero in exact arithmetic, absolutely: both within
    ``ZERO_TOL`` of the global norm, ``test_torch_train_archs.ZERO_GRAD``)."""
    res, ref, _, _ = both
    mesh = _mesh_of(job)
    specs = _specs_by_name(_cfg(*job.split("/")[:2]), mesh)
    zero = ZERO_TOL * float(ref[f"{job}/0/grad_norm"])
    for r in res:
        got = r[job]
        assert list(got["grads"]) == list(specs)
        for name, g in got["grads"].items():
            want = _cut(ref[f"{job}/grads/{name}"], specs[name], mesh,
                        got["coords"])
            if (_arch(job), name) in ZERO_GRAD:
                assert np.linalg.norm(g) <= zero, (got["coords"], name)
                assert np.linalg.norm(want) <= zero, name
                continue
            err = np.linalg.norm(g - want) / np.linalg.norm(want)
            assert err <= _grad_bound(job, name), (got["coords"], name, err)


@pytest.mark.parametrize("job", JOBS + POD_JOBS)
def test_parameter_and_moment_blocks_match_reference(both, job):
    """After each step, each rank's parameter blocks are the reference's.
    AdamW's moment blocks are too (``_opt_specs`` places moments as their
    parameters).  adamw8bit's and adafactor's state is replicated: every
    rank holds the same whole state, equal to the reference's (int8
    codes within 1, fp32 state and scales within ``PARAM_TOL`` of the
    leaf's largest value; the state of Mamba-2's ``A_log``, a square of
    its gradient, within twice its gradient's bound).  At an adamw8bit
    job's step 2 the elements whose step-1 codes moved are left out
    (``_moment_codes``) and counted, at most ``CODE_FLIPS`` of the
    job's.  The others' step-2 update divides by the square root of a
    quantized v, and its bound follows the update: ``PARAM_TOL`` for
    each ``lr`` it moves the element, and where the step-1 v code is 0
    (v then holds only the step-2 gradient's square, so the update is
    the ratio of m to that gradient element, thousands of ``lr`` where
    it is tiny) ``V0_REL`` of the update, the relative rounding of a
    near-zero gradient element (2.3e-2 at most at reduced
    starcoder2-3b, an update of 0.42)."""
    res, ref, _, _ = both
    mesh = _mesh_of(job)
    specs = _specs_by_name(_cfg(*job.split("/")[:2]), mesh)
    replicated = _opt_name(job) != "adamw"
    first = res[0][job]
    flips = n = 0
    for r in res:
        got = r[job]
        for i, st in enumerate(got["steps"]):
            for name, x in st["params"].items():
                whole = ref[f"{job}/{i}/params/{name}"]
                want = _cut(whole, specs[name], mesh, got["coords"])
                bound = PARAM_TOL
                mask, moved, vq = (None, 0, None) if i == 0 else \
                    _moment_codes(job, got, ref, name, specs[name], mesh,
                                  got["coords"])
                if mask is not None:
                    before = _cut(ref[f"{job}/0/params/{name}"], specs[name],
                                  mesh, got["coords"])[mask]
                    x, want, vq = x[mask], want[mask], vq[mask]
                    moves = np.abs(want - before)
                    bound = np.where(
                        vq == 0, PARAM_TOL + V0_REL * moves,
                        PARAM_TOL * np.maximum(
                            1.0, moves / _train_rank_worker.OPT["lr"]))
                    if r is res[0]:
                        flips, n = flips + moved, n + whole.size
                err = np.abs(x - want)
                assert (err <= bound).all(), (got["coords"], i, name,
                                              float(err.max(initial=0.0)))
            for part, tree in st["state"].items():
                for key, x in tree.items():
                    want = ref[f"{job}/{i}/{part}/{key}"]
                    leaf = key.rsplit("/", 1)[0] if replicated else key
                    if not replicated:
                        want = _cut(want, specs[key], mesh, got["coords"])
                        err = float(np.abs(x - want).max())
                        assert err <= PARAM_TOL, (i, part, key, err)
                        continue
                    np.testing.assert_array_equal(
                        x, first["steps"][i]["state"][part][key])
                    err = float(np.abs(x - want).max())
                    if key.endswith("/q"):
                        assert err <= 1, (i, part, key, err)
                        continue
                    bound = (2 * LEAF_TOL[_arch(job), leaf]
                             if (_arch(job), leaf) in LEAF_TOL
                             else PARAM_TOL)
                    assert err <= bound * float(np.abs(want).max(
                        initial=0.0)), (i, part, key, err)
    if n:
        print(f"{job}: {flips} of {n} elements' step-1 codes moved")
    assert flips <= CODE_FLIPS * max(n, 1)


@pytest.mark.parametrize("job", JOBS + POD_JOBS)
def test_parity_fresh_and_routes(both, job):
    """After each step every rank's parity equals a fresh encode of its
    new blocks; attention went through kernel 11's route (its plain
    version on the CPU) once an attention layer a step, never the masked
    one."""
    res, _, _, _ = both
    cfg = _cfg(*job.split("/")[:2])
    attention = sum(cfg.layers.count(k) for k in "AWM")
    mla = cfg.layers.count("L")
    for r in res:
        got = r[job]
        assert [st["stale"] for st in got["steps"]] == [0] * STEPS
        if mla:
            assert got["routes"]["mla_blockwise:torch"] == mla * STEPS
        if not attention:
            assert got["op_paths"] == {}
            assert not any(k.startswith(("flash", "masked"))
                           for k in got["routes"])
            continue
        assert got["op_paths"] == {"flash_attention": dispatch.TORCH_CPU}
        assert got["routes"]["flash_attention:torch-cpu"] == \
            attention * STEPS
        assert not any(k.startswith("masked") for k in got["routes"])


@pytest.mark.parametrize("job", JOBS + POD_JOBS)
def test_sent_bytes_equal_dry_run_count(both, job):
    """A step's bytes sent by kind on each rank equal
    ``dryrun.count_rank_train``'s count of the same step at its
    coordinates: the gathers (forward and remat recompute), the gradients'
    reduce-scatters, the all-reduces, the EC update's permutes, and
    adamw8bit's and adafactor's statistics' all-reduces (a max
    all-reduce for adamw8bit's block maxima) and adamw8bit's codes'
    all-gathers."""
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
    _, ref, saves, _ = both
    job = JOBS[0]
    params = _ref_params(job.split("/")[0])
    like = {"p": params, "o": {
        "m": params, "v": params, "count": jax.numpy.int32(0)}}
    state = ref_ckpt.restore_checkpoint(saves[job], STEPS, like)
    assert int(state["o"]["count"]) == STEPS
    for part, tree in (("params", state["p"]), ("m", state["o"]["m"]),
                       ("v", state["o"]["v"])):
        for p, x in jax.tree_util.tree_leaves_with_path(tree):
            name = jax.tree_util.keystr(p, simple=True, separator="/")
            want = ref[f"{job}/{STEPS - 1}/{part}/{name}"]
            assert np.abs(np.asarray(x) - want).max() <= PARAM_TOL, name


def test_rank_checkpoint_of_a_replicated_state_reads_in_the_reference(both):
    """The ranks' checkpoint of an adamw8bit job holds the replicated
    state once, whole: the reference's ``restore_checkpoint`` reads it
    into the reference's own state tree, equal to the reference's state
    after the last step (codes within 1, scales within ``PARAM_TOL`` of
    the leaf's largest)."""
    _, ref, saves, _ = both
    job = SAVES[1]
    params = _ref_params(_arch(job))
    like = {"p": params, "o": ref_opt.make_optimizer(
        _opt_name(job), **_train_rank_worker.OPT).init(params)}
    state = ref_ckpt.restore_checkpoint(saves[job], STEPS, like)
    assert int(state["o"]["count"]) == STEPS
    for part in ("m", "v"):
        for p, x in jax.tree_util.tree_leaves_with_path(state["o"][part]):
            key = jax.tree_util.keystr(p, simple=True, separator="/")
            want = ref[f"{job}/{STEPS - 1}/{part}/{key}"]
            x = np.asarray(x, np.float32)
            assert x.shape == want.shape, key
            bound = 1 if key.endswith("/q") else \
                PARAM_TOL * max(1.0, float(np.abs(want).max()))
            assert np.abs(x - want).max() <= bound, key


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


def test_dry_run_cell_bytes_equal_a_ranks_sends(both):
    """The dry run's training cell of ``CELL_JOB``'s arch with the CLI's
    default adamw8bit (its config as the job runs it, remat "full",
    B x S of the jobs) on (4, 2) reports, at every position it counts,
    the bytes by kind that the rank at those coordinates sent in the
    job's second step, less the EC copy's permutes (the cell keeps no EC
    copy)."""
    res, _, _, _ = both
    arch, mode = CELL_JOB.split("/")[:2]
    saved = dryrun.get_config
    dryrun.get_config = lambda a: _cfg(a, mode)
    try:
        cell = dryrun.run_cell(arch, "train_4k", make_mesh(
            MESH, ("data", "model")), optimizer=_opt_name(CELL_JOB),
            batch=B, seq=S)
    finally:
        dryrun.get_config = saved
    assert cell["count"] == "rank"
    sent = {tuple(r[CELL_JOB]["coords"]): r[CELL_JOB]["sent"] for r in res}
    assert len(cell["positions"]) == MESH[1]
    for pos in cell["positions"]:
        counted = {k: v for k, v in pos["collectives"].items() if v}
        want = {k: v for k, v in sent[tuple(pos["coords"])].items()
                if k != "collective-permute"}
        assert counted == want, pos["coords"]


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


def test_expert_count_must_split_to_train():
    """Training a config whose expert count the model axis does not
    divide on a (2, 2) mesh raises a ``ValueError`` (MoE layers train
    across ranks above; the attention options in
    ``tests/test_torch_serve_ranks.py``)."""
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_reduced("llama4-maverick-400b-a17b").scaled(num_experts=7)
    with pytest.raises(ValueError, match="expert count 7 does not split"):
        launch_train.train_on_rank(counting_comms(mesh, (1, 0)), cfg, {},
                                   steps=1, log=lambda *a: None)


def test_dry_run_counts_a_rank_train_cell():
    """The dry run counts a dense train cell on a mesh as one rank's
    train step (``count_rank_train`` at every model position), with
    AdamW and with the CLI's adamw8bit alike; adamw8bit adds its block
    maxima's all-reduces and its codes' all-gathers, and nothing to the
    gradients' reduce-scatters."""
    saved = dryrun.get_config
    dryrun.get_config = get_reduced
    try:
        mesh = make_mesh((2, 2), ("data", "model"))
        res = dryrun.run_cell(ARCHS[0], "train_4k", mesh, optimizer="adamw",
                              batch=B, seq=S)
        cli = dryrun.run_cell(ARCHS[0], "train_4k", mesh, batch=B, seq=S)
    finally:
        dryrun.get_config = saved
    for cell in (res, cli):
        assert cell["count"] == "rank"
        assert sorted(tuple(p["coords"]) for p in cell["positions"]) == \
            [(0, 0), (0, 1)]
        assert all(cell["collectives"][k] > 0 for k in (
            "all-gather", "reduce-scatter", "all-reduce"))
    assert cli["collectives"]["reduce-scatter"] == \
        res["collectives"]["reduce-scatter"]
    for kind in ("all-gather", "all-reduce"):
        assert cli["collectives"][kind] > res["collectives"][kind]


#: the rank optimizers' unit check: a (data 2, model 2) mesh and leaves
#: laid out every way a parameter is (a stacked leaf whose 720 elements
#: span quantization blocks across its layers, a vocab-major table, a
#: split vector, a replicated one, a row-split matrix, MoE experts split
#: over "model" on their leading dimension)
OPT_MESH = (2, 2)
OPT_SHAPES = {"e": (24, 10), "n": (10,), "v": (20,), "w": (3, 12, 20),
              "x": (6, 8), "m": (4, 6, 10)}
OPT_SPECS = {"e": sharding.P("model", "data"), "n": sharding.P(),
             "v": sharding.P("model"), "w": sharding.P(None, "data", "model"),
             "x": sharding.P("data", None),
             "m": sharding.P("model", "data", None)}
OPT_NAMES = ("adamw", "adamw8bit", "adafactor")
OPT_KW = dict(lr=0.05, warmup_steps=2, total_steps=10)


def _opt_tree(seed) -> dict:
    rng = np.random.default_rng(seed)
    tree = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in OPT_SHAPES.items()}
    tree["w"] = Stacked(t.clone() for t in tree["w"])
    return tree


@pytest.fixture(scope="module")
def rank_optimizers(tmp_path_factory):
    """(each rank's parameter blocks and state after each of two steps of
    each optimizer, the one-card optimizer's whole trees after them)."""
    mesh = make_mesh(OPT_MESH, ("data", "model"))
    params, grads = _opt_tree(100), [_opt_tree(s) for s in range(2)]
    res = ranks.launch(
        _train_rank_worker.optimizer_body, mesh,
        [(params, grads, OPT_SPECS, OPT_NAMES, OPT_KW)] * mesh.size,
        init_file=str(tmp_path_factory.mktemp("opt_ranks") / "init"),
        timeout=DEADLINE)
    want = {}
    for name in OPT_NAMES:
        opt = make_optimizer(name, **OPT_KW)
        tree = _opt_tree(100)
        state = opt.init(tree)
        want[name] = []
        for g in grads:
            opt.apply(g, state, tree)
            want[name].append({"params": _train_rank_worker._np(tree),
                               "state": _train_rank_worker._np(state)})
    return res, want


@pytest.mark.parametrize("name", OPT_NAMES)
def test_rank_optimizer_is_the_one_card_optimizer(rank_optimizers, name):
    """Each optimizer on a rank's blocks (``optimizer.Blocks``) steps them
    as the one-card optimizer steps the whole leaves: AdamW and adamw8bit
    bit for bit (the block maxima's max all-reduce is exact), adafactor
    within 1e-6 (its row, column and RMS sums run in another order).
    AdamW's moments are the rank's blocks; adamw8bit's codes and scales
    and adafactor's factors are the whole state, the same on every rank."""
    res, want = rank_optimizers
    mesh = make_mesh(OPT_MESH, ("data", "model"))

    def check(x, whole, key):
        if name == "adafactor":
            np.testing.assert_allclose(x, whole, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(x, whole, err_msg=key)
    for r in res:
        for i, (got, w) in enumerate(zip(r[name], want[name])):
            for key, x in got["params"].items():
                check(x, _cut(w["params"][key], OPT_SPECS[key], mesh,
                              r["coords"]), key)
            for key, x in got["state"].items():
                whole = w["state"][key]
                if key == "count":
                    assert x == whole
                elif name == "adamw":              # the moments' blocks
                    check(x, _cut(whole, OPT_SPECS[key.split("/")[1]], mesh,
                                  r["coords"]), key)
                else:                              # whole on every rank
                    np.testing.assert_array_equal(
                        x, res[0][name][i]["state"][key])
                    check(x, whole, key)
