"""Protected serving and training across ranks with the attention options,
against the port's own one-device programs on the same weights.

One spawn of 4 gloo ranks on the CPU over (data 2, model 2)
(``tests/_serve_rank_worker.py``), as ``launch.serve --protect`` protects
a cache (RS(k=1, m=1) over "data", 256-byte pages):

* reduced starcoder2-3b with the attention options of
  ``test_torch_model_ranks.OPTIONS`` (layers "AW" with a 16-slot window,
  the int8 KV cache, both softcaps) in fp32, B 2 (one row a data
  position): an 8-token prefill through ``ServeEngine``, the cache
  protected by ``cache_specs`` of the engine's ``cache_shapes``, 14
  greedy decode steps (the "W" ring wraps after 16 positions),
  ``refresh_cache_parity``.  Held, byte for byte: each rank's pages and
  parity after the prefill and after the refresh against the stacked
  one-card ``ECStateStore`` over the cache gathered from every rank's
  block; the refreshed parity against a fresh encode; every data
  position's pages rebuilt over the ring on every rank of its column;
* reduced recurrentgemma-2b (RG-LRU layers beside "W" layers),
  reduced minicpm3-4b (MLA layers, whose "latent" and "k_rope" slots
  split over "model": the 22 positions cross the boundary of the two
  12-slot slices), the same with 3 heads ("mla-h3": the head leaves
  whole on both model positions, ``wo`` split by flat rows across a
  head) and the reduced MoE archs (llama4-maverick-400b-a17b,
  kimi-k2-1t-a32b: their experts split over "model") in fp32, served
  the same way: their pages and parity
  after the prefill and after the refresh against the stacked store,
  byte for byte, and every data position rebuilt;
* two AdamW steps (``launch.train.train_on_rank`` with its EC copy, as
  ``tests/test_torch_train_ranks.py`` runs it) of reduced qwen2-vl-7b
  (M-RoPE, an embeddings input) and of the options config, "seq" and
  "head", in fp32 on ``SyntheticLM``'s batch (seed 0), against the
  one-device ``make_train_step`` on the same weights and batch
  (``train_step.recorded_step``): step 1's loss, gradient norm, each
  rank's gradient blocks and parameter blocks after it at
  ``tests/test_torch_train_archs.py``'s fp32 bounds; the parity fresh
  after each step; step 2's bytes sent by kind equal to
  ``dryrun.count_rank_train``'s count.
"""
import numpy as np
import pytest
import torch

import _serve_rank_worker
import _train_rank_worker
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import ranks, sharding
from repro_torch.distributed.ecstore import ECConfig, ECStateStore
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models.convert import param_tree
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import recorded_step
from repro_torch.tree import leaves_with_path, path_str, tree_map
from test_torch_model_ranks import OPTIONS, VARIANTS
from test_torch_train_archs import GRAD_TOL, LOSS_TOL, PARAM_TOL

torch.set_num_threads(1)

MESH = (2, 2)
B = 2
PROMPT, STEPS, MAX_LEN = 8, 14, 24
EC = dict(k=1, m=1, page_size=256)
TRAIN = ("qwen2-vl-7b/seq", "options/seq", "options/head")
#: the other archs' jobs ("arch/mode") whose protected caches are
#: rebuilt, by session name: RG-LRU states and the "W" ring; MLA's latent
#: cache, with heads split over "model" and whole ("minicpm3-h3",
#: ``test_torch_model_ranks.VARIANTS``); the MoE archs' attention caches
#: (their experts split over "model"; kimi-k2 on the "head" path)
SESSIONS = {"recurrent": "recurrentgemma-2b/seq", "mla": "minicpm3-4b/seq",
            "mla-h3": "minicpm3-h3/seq",
            "llama4": "llama4-maverick-400b-a17b/seq",
            "kimi": "kimi-k2-1t-a32b/auto"}
#: the leaves of each session's cache tree
SESSION_LEAVES = {"recurrent": 6, "mla": 2, "mla-h3": 2, "llama4": 2,
                  "kimi": 2}
MOE_SESSIONS = ("llama4", "kimi")
SEQ = 64
SEED = 26
DEADLINE = 300.0


def _cfg(arch, mode="seq"):
    base, extra = VARIANTS.get(arch, (arch, {}))
    return get_reduced(base).scaled(dtype="float32", attn_parallel=mode,
                                    remat="full", **extra)


def _model(job) -> Model:
    return Model(_cfg(*job.split("/")), device="cpu").init(
        torch.Generator().manual_seed(SEED))


def _blocks(model: Model, mesh, coords) -> dict:
    params = param_tree(model)
    specs = sharding.param_specs(model.cfg, params, mesh)
    return tree_map(lambda leaf, spec: sharding.local_block(
        leaf, spec, mesh, coords), params, specs)


def _batch(cfg):
    """``train_on_rank``'s first batch (``SyntheticLM``, seed 0)."""
    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=B, seed=0,
        embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0,
        mrope=cfg.rope_kind == "mrope"), device="cpu").batch(0)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(the served model, its prompt, the ranks' results, the trained
    models by job, the other sessions' served models by name)."""
    tmp = tmp_path_factory.mktemp("serve_ranks")
    mesh = make_mesh(MESH, ("data", "model"))
    served = _model("options/seq")
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, served.cfg.vocab_size, (B, PROMPT)))
    trained = {job: _model(job) for job in TRAIN}
    others = {name: _model(job) for name, job in SESSIONS.items()}
    args = [((served.cfg, _blocks(served, mesh, mesh.coords(r)), prompt,
              STEPS, MAX_LEN, EC),
             [(job, m.cfg, _blocks(m, mesh, mesh.coords(r)), B, SEQ)
              for job, m in trained.items()],
             [(name, (m.cfg, _blocks(m, mesh, mesh.coords(r)), prompt,
                      STEPS, MAX_LEN, EC)) for name, m in others.items()])
            for r in range(mesh.size)]
    res = ranks.launch(_serve_rank_worker.serve_body, mesh, args,
                       init_file=str(tmp / "init"), timeout=DEADLINE)
    return served, prompt, res, trained, others


def _gathered(cfg, res, key, session="protect") -> dict:
    """The whole cache (the reference's stacked layout, plain tensors),
    each leaf assembled from every rank's block (``key``: the point of
    the session), and its ``cache_specs``."""
    mesh = make_mesh(MESH, ("data", "model"))
    with dispatch.dry_run():
        meta = Model(cfg, device="meta")
    shapes = meta.cache_tree(meta.init_cache(B, MAX_LEN, torch.float32))
    specs = sharding.cache_specs(cfg, shapes, mesh)
    tree = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), shapes)
    flat_specs = {path_str(k): s for k, s in leaves_with_path(specs)}
    for r in res:
        for path, leaf in leaves_with_path(tree):
            name = path_str(path)
            view = sharding.local_view(leaf, flat_specs[name], mesh)
            view[tuple(r["coords"])].copy_(torch.from_numpy(
                r[session][key][name]))
    return tree, specs


@pytest.mark.parametrize("when", ("prefill", "refresh"))
def test_rank_cache_pages_equal_the_stacked_store(spawned, when):
    """Each rank's pages and parity, after the prefill's ``protect_cache``
    and after the decode steps' ``refresh_cache_parity``, equal the
    stacked store's over the cache gathered from every rank's block, byte
    for byte; every leaf of the cache (the int8 K/V and their scales, the
    "A" layer's slots and the "W" layer's ring) is packed."""
    served, _, res, _, _ = spawned
    key = {"prefill": "prefill_cache", "refresh": "cache"}[when]
    tree, specs = _gathered(served.cfg, res, key)
    mesh = make_mesh(MESH, ("data", "model"))
    store = ECStateStore(mesh, specs, ECConfig(**EC))
    pages, parity = store.local_pages(tree), store.encode(tree)
    for r in res:
        got, at = r["protect"], tuple(r["coords"])
        assert got["n_leaves"] == 8
        prefix = "prefill_" if when == "prefill" else ""
        np.testing.assert_array_equal(got[f"{prefix}pages"],
                                      pages[at].numpy())
        np.testing.assert_array_equal(got[f"{prefix}parity"],
                                      parity[at].numpy())


def test_refresh_is_a_fresh_encode_and_every_position_rebuilds(spawned):
    """After the decode steps (the ring wrapped), the refreshed parity is
    a fresh encode of the cache on every rank, and each data position's
    pages, rebuilt over the ring, equal that position's live pages on
    every rank of its model column; the products took the CPU path."""
    _, _, res, _, _ = spawned
    live = {tuple(r["coords"]): r["protect"]["pages"] for r in res}
    for r in res:
        got = r["protect"]
        assert got["cur_len"] == PROMPT + STEPS > OPTIONS["local_window"]
        np.testing.assert_array_equal(got["parity"], got["fresh"])
        for f, rebuilt in enumerate(got["rebuilt"]):
            np.testing.assert_array_equal(rebuilt,
                                          live[(f, r["coords"][1])])
        assert set(got["op_paths"].values()) == {dispatch.TORCH_CPU}


@pytest.mark.parametrize("when", ("prefill", "refresh"))
def test_recurrent_cache_pages_equal_the_stacked_store(spawned, when):
    """recurrentgemma-2b's protected cache on a rank - the RG-LRU "conv"
    and "h" states of its channels and the "W" ring's slice, every leaf
    packed - gives the stacked store's pages and parity over the cache
    gathered from every rank's block, byte for byte, after the prefill
    and after the refresh."""
    _session_pages_equal_the_stacked_store(spawned, "recurrent", when)


def test_recurrent_cache_rebuilds_byte_for_byte(spawned):
    """After recurrentgemma-2b's decode steps the refreshed parity is a
    fresh encode on every rank, and each data position's pages, rebuilt
    over the ring, equal its live pages byte for byte."""
    _session_rebuilds_byte_for_byte(spawned, "recurrent")


@pytest.mark.parametrize("when", ("prefill", "refresh"))
def test_mla_cache_pages_equal_the_stacked_store(spawned, when):
    """minicpm3-4b's protected latent cache on a rank - its batch row and
    its slice of the "latent" and "k_rope" slots - gives the stacked
    store's pages and parity over the cache gathered from every rank's
    block, byte for byte, after the prefill and after the refresh."""
    _session_pages_equal_the_stacked_store(spawned, "mla", when)


@pytest.mark.parametrize("when", ("prefill", "refresh"))
def test_whole_head_mla_cache_pages_equal_the_stacked_store(spawned, when):
    """The same with 3 heads ("mla-h3"), whose head leaves are whole on
    both model positions and whose ``wo`` splits across a head."""
    _session_pages_equal_the_stacked_store(spawned, "mla-h3", when)


def test_mla_cache_rebuilds_byte_for_byte(spawned):
    """After minicpm3-4b's decode steps, which wrote both model
    positions' slices, the refreshed parity is a fresh encode on every
    rank, and each data position's pages, rebuilt over the ring, equal
    its live pages byte for byte."""
    _mla_rebuilds_byte_for_byte(spawned, "mla")


def test_whole_head_mla_cache_rebuilds_byte_for_byte(spawned):
    """The same with 3 heads ("mla-h3"), its heads whole on both model
    positions."""
    _mla_rebuilds_byte_for_byte(spawned, "mla-h3")


def _mla_rebuilds_byte_for_byte(spawned, name):
    _session_rebuilds_byte_for_byte(spawned, name)
    _, _, res, _, _ = spawned
    for r in res:
        lat = r[name]["cache"]["blocks/0/latent"]      # (R, row, slots, r)
        assert PROMPT + STEPS > lat.shape[2]
        assert (np.abs(lat).sum(-1) > 0).sum(-1).min() == min(
            lat.shape[2], PROMPT + STEPS - r["coords"][1] * lat.shape[2])


@pytest.mark.parametrize("when", ("prefill", "refresh"))
@pytest.mark.parametrize("name", MOE_SESSIONS)
def test_moe_cache_pages_equal_the_stacked_store(spawned, name, when):
    """An MoE arch's protected cache on a rank (its attention K and V:
    its batch row and its slice of the slots) gives the stacked store's
    pages and parity over the cache gathered from every rank's block,
    byte for byte, after the prefill and after the refresh."""
    _session_pages_equal_the_stacked_store(spawned, name, when)


@pytest.mark.parametrize("name", MOE_SESSIONS)
def test_moe_cache_rebuilds_byte_for_byte(spawned, name):
    """After an MoE arch's decode steps the refreshed parity is a fresh
    encode on every rank, and each data position's pages, rebuilt over
    the ring, equal its live pages byte for byte."""
    _session_rebuilds_byte_for_byte(spawned, name)


def _session_pages_equal_the_stacked_store(spawned, name, when):
    _, _, res, _, others = spawned
    key = {"prefill": "prefill_cache", "refresh": "cache"}[when]
    tree, specs = _gathered(others[name].cfg, res, key, name)
    mesh = make_mesh(MESH, ("data", "model"))
    store = ECStateStore(mesh, specs, ECConfig(**EC))
    pages, parity = store.local_pages(tree), store.encode(tree)
    prefix = "prefill_" if when == "prefill" else ""
    for r in res:
        got, at = r[name], tuple(r["coords"])
        assert got["n_leaves"] == SESSION_LEAVES[name]
        np.testing.assert_array_equal(got[f"{prefix}pages"],
                                      pages[at].numpy())
        np.testing.assert_array_equal(got[f"{prefix}parity"],
                                      parity[at].numpy())


def _session_rebuilds_byte_for_byte(spawned, name):
    _, _, res, _, _ = spawned
    live = {tuple(r["coords"]): r[name]["pages"] for r in res}
    for r in res:
        got = r[name]
        assert got["cur_len"] == PROMPT + STEPS
        np.testing.assert_array_equal(got["parity"], got["fresh"])
        for f, rebuilt in enumerate(got["rebuilt"]):
            np.testing.assert_array_equal(rebuilt,
                                          live[(f, r["coords"][1])])


@pytest.fixture(scope="module")
def one_device(spawned):
    """The one-device step of each trained job on the same weights and
    batch."""
    trained = spawned[3]
    opt = make_optimizer("adamw", **_train_rank_worker.OPT)
    return {job: recorded_step(m, opt, _batch(m.cfg))
            for job, m in trained.items()}


@pytest.mark.parametrize("job", TRAIN)
def test_rank_step_matches_the_one_device_step(spawned, one_device, job):
    """Every rank's loss and gradient norm are the one-device step's; its
    gradient blocks and parameter blocks after the step are the same
    blocks of the one-device step's (fp32 bounds)."""
    _, _, res, trained, _ = spawned
    want = one_device[job]
    mesh = make_mesh(MESH, ("data", "model"))
    cfg = trained[job].cfg
    specs = {path_str(k): s for k, s in leaves_with_path(
        sharding.param_specs(cfg, param_tree(trained[job]), mesh))}
    for r in res:
        got = r[job]
        step = got["steps"][0]
        assert abs(step["loss"] - want["loss"]) <= LOSS_TOL["float32"]
        assert abs(step["grad_norm"] - want["grad_norm"]) / \
            want["grad_norm"] <= GRAD_TOL["float32"]
        for part, have, ref in (("grads", got["grads"], want["grads"]),
                                ("params", step["params"], want["params"])):
            assert list(have) == list(specs)
            for name, x in have.items():
                full = torch.from_numpy(np.asarray(ref[name]))
                block = sharding.local_block(full, specs[name], mesh,
                                             got["coords"]).numpy()
                if part == "grads":
                    norm = np.linalg.norm(block)
                    err = np.linalg.norm(x - block) / max(norm, 1e-30)
                    assert err <= GRAD_TOL["float32"] or norm == 0, (
                        got["coords"], name, err)
                else:
                    err = float(np.abs(x - block).max())
                    assert err <= PARAM_TOL, (got["coords"], name, err)


@pytest.mark.parametrize("job", TRAIN)
def test_rank_step_parity_routes_and_bytes(spawned, job):
    """The EC copy is fresh after each step; a softcapped config's
    attention takes the masked route (its "W" layer the masked stripes),
    another's kernel 11's; step 2's bytes sent by kind equal
    ``dryrun.count_rank_train``'s count at the rank's coordinates."""
    _, _, res, trained, _ = spawned
    cfg = trained[job].cfg
    for r in res:
        got = r[job]
        assert [st["stale"] for st in got["steps"]] == [0, 0]
        if cfg.attn_logit_softcap:
            assert got["op_paths"] == {}
            assert got["routes"]["masked_blockwise:torch"] > 0
            assert not any(k.startswith("flash") for k in got["routes"])
        else:
            assert got["op_paths"] == {"flash_attention": dispatch.TORCH_CPU}
        assert got["sent"] == got["counted"], got["coords"]
