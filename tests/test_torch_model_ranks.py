"""A model of attention layers across ranks (``models/ranked.py``)
against the JAX package's model under ``set_activation_mesh`` on a (4, 2)
mesh.

Reference side: one subprocess with 8 forced host devices runs the
reference's ``Model.apply`` and a token-by-token greedy ``decode_step``
loop under ``set_activation_mesh(make_test_mesh(4, 2))``, the parameters
placed by ``param_specs``, the batch by ``batch_specs`` and an fp32 cache
by ``cache_specs``, in fp32 with ``attn_parallel`` "seq" and "head", for
reduced starcoder2-3b and phi4-mini-3.8b; qwen2-vl-7b (M-RoPE on three
distinct position streams, an embeddings input) and musicgen-medium (an
embeddings input), their prompts fed as embeddings and their greedy
tokens fed back through the table; and starcoder2-3b with the attention
options (``OPTIONS``: layers "AW" with a 16-slot window, the int8 KV
cache, both softcaps), decoded to 24 positions so that the "W" layer's
ring wraps; and the recurrent archs (``RECURRENT``): recurrentgemma-2b
(RG-LRU "R" layers beside "W" layers, "seq" and "head") and mamba2-370m
(Mamba-2 "S" layers, whose 296 packed ``in_proj`` columns and 160 conv
channels split over "model" across its heads), with their caches after
the decode; and the MLA jobs (``MLA``): reduced minicpm3-4b, "seq" and
"head", the same with its queries through one ``wq`` (q_lora_rank 0),
and with 3 heads ("minicpm3-h3"), which the 2 model positions do not
divide (``param_specs`` leaves the head leaves whole and splits ``wo``'s
48 rows 24 a position, 1.5 heads: the layout of minicpm3-4b's 40 heads
on 16), whose latent caches after the decode are held too; and the MoE jobs
(``MOE``): reduced llama4-maverick-400b-a17b (8 experts, top-1, "seq")
and kimi-k2-1t-a32b (16 experts, top-4, its 4 heads on the "head"
path), whose experts split over "model".  Also its striped
``blockwise_attention`` at S 64 and at a ragged S 80 (padded to 128
rows, the second stripe's last 48 rows padding), its ``_mla_blockwise``
at the same lengths, and its ``_local_attention`` at S 80 with a 32-row
window and a softcap (three windows, the last half padding).  The
weights are the reference's ``Model.init(PRNGKey(SEED))``, drawn again
in this process and converted by ``models.convert.params_from_jax``.

Port side, while the reference compiles: 8 gloo ranks on the CPU
(``ranks.launch``), each with its ``sharding.local_block`` of every leaf,
run ``RankModel.apply`` and ``ServeEngine`` decoding, greedy and sampled
(``tests/_model_rank_worker.py``).  B 4 and S 64 put one batch row on
each data position, and the "seq" stripes are two 32-row tiles
(bq = min(32, max(64 // 2, 16))).

Held: each rank's logits block against the same block of the
reference's (fp32: ``ATOL`` 2e-5, ``RTOL`` 1e-4, where the two sum in
different orders), its logits block after the prompt, the greedy tokens
exactly; the tokens sampled at temperature 1.0 against the one-device
port engine's from the same seed, and ``RankModel.sample`` on each
rank's block of given logits against ``Model.sample`` on them, exactly;
``flash_attention_plain`` on each stripe,
``layers.local_attention_stripe`` on each window's stripe and
``layers._mla_blockwise`` on each stripe against the reference's rows
at those positions; a stripe count of 1 against the unstriped call, bit
for bit; a 1 x 1 mesh against the one-device model,
bit for bit (a dense and both MoE archs); each rank's bytes sent by kind
against the dry run's count
of the same forward (``dryrun.count_rank_forward``); a recurrent job's
or MLA job's cache block after the decode against the same block of the
reference's (fp32 bounds; an MLA decode writes both model positions'
slices of the latent cache); an MoE job's routes and keep flags on each
rank against the one-device port model's rows, exactly, with drops; a
decode step with whole MLA heads gathering no query and repeating the
head products on every model position (counted on ``meta``); and a
Mamba-2 head count, an expert count or an MLA config's d_ff that the
model axis does not divide raising.
"""
import functools
import json
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import _model_rank_worker
from conftest import subprocess_env
from repro.configs import get_reduced as ref_get_reduced
from repro.models import Model as RefModel
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import ranks, sharding
from repro_torch.distributed.ranks import counting_comms
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 stripe_positions)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import Model, layers, moe, ranked
from repro_torch.models.convert import param_tree, params_from_jax
from repro_torch.serve.engine import ServeEngine, greedy_generate
from repro_torch.tree import leaves_with_path, path_str, tree_map

torch.set_num_threads(1)

ARCHS = ("starcoder2-3b", "phi4-mini-3.8b", "qwen2-vl-7b",
         "musicgen-medium", "options")
MODES = ("seq", "head")
#: the recurrent archs' jobs (RG-LRU with "W" layers, Mamba-2 alone, whose
#: layers have no attention mode)
RECURRENT = ["recurrentgemma-2b/seq", "recurrentgemma-2b/head",
             "mamba2-370m/seq"]
#: the MLA jobs: minicpm3-4b in both modes (neither changes an MLA layer),
#: its queries through one ``wq`` (q_lora_rank 0, "minicpm3-wq"), and its
#: 3 heads ("minicpm3-h3") whole on both model positions
MLA = ["minicpm3-4b/seq", "minicpm3-4b/head", "minicpm3-wq/seq",
       "minicpm3-h3/seq"]
#: the MoE jobs: llama4-maverick's top-1 router under "seq" attention,
#: kimi-k2's top-4 under its config's "auto" (its 4 heads split over the
#: 2 model positions: the "head" path)
MOE = ["llama4-maverick-400b-a17b/seq", "kimi-k2-1t-a32b/auto"]
JOBS = [f"{a}/{m}" for a in ARCHS for m in MODES] + RECURRENT + MLA + MOE
#: the jobs whose cache after the decode is held block by block
CACHED = RECURRENT + MLA
#: the attention options on reduced starcoder2-3b ("options" jobs)
OPTIONS = dict(layer_pattern="AW", local_window=16, kv_cache_dtype="int8",
               attn_logit_softcap=50.0, logit_softcap=30.0)
#: the jobs' arch names that are a reduced config with options: (its
#: config's name, the options)
VARIANTS = {"options": ("starcoder2-3b", OPTIONS),
            "minicpm3-wq": ("minicpm3-4b", dict(q_lora_rank=0)),
            "minicpm3-h3": ("minicpm3-4b", dict(num_heads=3,
                                                num_kv_heads=3))}
MESH = (4, 2)
B, S = 4, 64
#: prompt tokens, then greedy tokens a job (the "options" jobs decode to
#: 24 positions: their ring of 16 slots wraps; "minicpm3-wq" to 21, which
#: the 2 model positions do not divide: ``cache_specs`` leaves its latent
#: cache's slots whole on every rank)
PROMPT, STEPS = 16, {"options": 8, "minicpm3-wq": 5}
ATTN_S = (64, 80)
#: the reference's ``_local_attention`` case: S, window, softcap
LOCAL = (80, 32, 50.0)
SEED = 24
#: fp32 logits: the reference's GSPMD program and the ranks sum in
#: different orders
ATOL, RTOL = 2e-5, 1e-4
DEADLINE = 300.0

REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_reduced
from repro.distributed import sharding as shd
from repro.launch.mesh import make_test_mesh
from repro.models import Model, set_activation_mesh
from repro.models.layers import (_local_attention, _mla_blockwise,
                                 blockwise_attention)

inp = dict(np.load(sys.argv[1]))
mesh = make_test_mesh(*MESH)
set_activation_mesh(mesh)

def named(t):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                        is_leaf=lambda x: isinstance(x, P))

def config(arch, mode):
    base, extra = VARIANTS.get(arch, (arch, {}))
    return get_reduced(base).scaled(dtype="float32", attn_parallel=mode,
                                    **extra)

def flat(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(x) for p, x in jax.tree_util.tree_leaves_with_path(tree)}

out = {}
for job in JOBS:
    arch, mode = job.split("/")
    cfg = config(arch, mode)
    steps = STEPS.get(arch, 4)
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(SEED))
    params = jax.device_put(params, named(shd.param_specs(cfg, params,
                                                          mesh)))
    emb = cfg.input_mode == "embeddings"
    batch = ({"embeddings": jnp.asarray(inp[f"emb/{arch}"])} if emb
             else {"tokens": jnp.asarray(inp["tokens"])})
    if cfg.rope_kind == "mrope":
        batch["positions"] = jnp.asarray(inp["positions"])
    batch = jax.device_put(batch, named(shd.batch_specs(cfg, batch,
                                                        mesh)))
    with mesh:
        logits = jax.jit(model.apply)(params, batch)
        cache = model.init_cache(B, PROMPT + steps, dtype=jnp.float32)
        cache = jax.device_put(cache, named(shd.cache_specs(cfg, cache,
                                                            mesh)))
        dec = jax.jit(model.decode_step)
        for t in range(PROMPT):
            x = (jnp.asarray(inp[f"emb/{arch}"][:, t:t + 1]) if emb
                 else jnp.asarray(inp["tokens"][:, t]))
            lg, cache = dec(params, cache, x, jnp.int32(t))
        out[f"{arch}/{mode}/dec_logits"] = np.asarray(lg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks = [np.asarray(tok)]
        for s in range(steps - 1):
            lg, cache = dec(params, cache, tok, jnp.int32(PROMPT + s))
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(tok))
    out[f"{arch}/{mode}/logits"] = np.asarray(logits)
    out[f"{arch}/{mode}/tokens"] = np.stack(toks, axis=1)
    if job in CACHED:
        for k, v in flat(cache).items():
            out[f"{job}/cache/{k}"] = v
cfg = get_reduced(ARCHS[0]).scaled(dtype="float32", attn_parallel="seq")
attend = jax.jit(lambda q, k, v: blockwise_attention(q, k, v, cfg))
for Sa in ATTN_S:
    with mesh:
        out[f"attn{Sa}"] = np.asarray(attend(inp[f"q{Sa}"], inp[f"k{Sa}"],
                                             inp[f"v{Sa}"]))
Sl, W, cap = LOCAL
cfg_l = cfg.scaled(local_window=W, attn_logit_softcap=cap)
with mesh:
    out["local"] = np.asarray(jax.jit(lambda q, k, v: _local_attention(
        q, k, v, cfg_l))(inp[f"q{Sl}"], inp[f"k{Sl}"], inp[f"v{Sl}"]))
cfg_m = get_reduced("minicpm3-4b").scaled(dtype="float32")
mla = jax.jit(lambda qn, qr, lat, kr, uk, uv: _mla_blockwise(
    qn, qr, lat, kr, {"w_uk": uk, "w_uv": uv}, cfg_m))
for Sa in ATTN_S:
    with mesh:
        out[f"mla{Sa}"] = np.asarray(mla(*(inp[f"mla_{x}{Sa}"] for x in (
            "qn", "qr", "lat", "kr")), inp["mla_w_uk"], inp["mla_w_uv"]))
np.savez(sys.argv[2], **out)
"""


def _cfg(arch, mode="seq"):
    base, extra = VARIANTS.get(arch, (arch, {}))
    return get_reduced(base).scaled(dtype="float32", attn_parallel=mode,
                                    **extra)


def _steps(job) -> int:
    return STEPS.get(job.split("/")[0], 4)


def _inputs() -> dict:
    rng = np.random.default_rng(SEED)
    cfg = _cfg(ARCHS[0])
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
           .astype(np.int32)}
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for Sa in ATTN_S:
        out[f"q{Sa}"] = rng.standard_normal((2, Sa, H, hd), np.float32)
        out[f"k{Sa}"] = rng.standard_normal((2, Sa, KV, hd), np.float32)
        out[f"v{Sa}"] = rng.standard_normal((2, Sa, KV, hd), np.float32)
    m = _cfg(MLA[0].split("/")[0])
    H, r = m.num_heads, m.kv_lora_rank
    for Sa in ATTN_S:
        for x, shape in (("qn", (2, Sa, H, m.qk_nope_dim)),
                         ("qr", (2, Sa, H, m.qk_rope_dim)),
                         ("lat", (2, Sa, r)),
                         ("kr", (2, Sa, 1, m.qk_rope_dim))):
            out[f"mla_{x}{Sa}"] = rng.standard_normal(shape, np.float32)
    out["mla_w_uk"] = rng.standard_normal((r, H, m.qk_nope_dim), np.float32)
    out["mla_w_uv"] = rng.standard_normal((r, H, m.v_head_dim), np.float32)
    for arch in ARCHS:
        c = _cfg(arch)
        if c.input_mode == "embeddings":
            out[f"emb/{arch}"] = rng.standard_normal((B, S, c.d_model),
                                                     np.float32)
    # three distinct (t, h, w) position streams
    out["positions"] = np.stack([np.sort(rng.integers(0, S, (B, S)), axis=1)
                                 for _ in range(3)]).astype(np.int32)
    return out


def _batch(job, inp) -> dict:
    """The job's prefill batch as the port takes it."""
    cfg = _cfg(*job.split("/"))
    arch = job.split("/")[0]
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": torch.from_numpy(inp[f"emb/{arch}"])}
    else:
        batch = {"tokens": torch.from_numpy(inp["tokens"]).long()}
    if cfg.rope_kind == "mrope":
        batch["positions"] = torch.from_numpy(inp["positions"]).long()
    return batch


@functools.lru_cache(maxsize=None)
def _ref_params(arch) -> dict:
    """The reference's ``Model.init(PRNGKey(SEED))`` (numpy leaves)."""
    base, extra = VARIANTS.get(arch, (arch, {}))
    ref_cfg = ref_get_reduced(base).scaled(dtype="float32", **extra)
    return jax.tree.map(np.asarray,
                        RefModel(ref_cfg).init(jax.random.PRNGKey(SEED)))


def _port_model(arch, mode="seq") -> Model:
    """The reference's ``Model.init(PRNGKey(SEED))`` in the port's model."""
    return params_from_jax(Model(_cfg(arch, mode), device="cpu"),
                           _ref_params(arch))


def _blocks(model: Model, mesh, coords) -> dict:
    params = param_tree(model)
    specs = sharding.param_specs(model.cfg, params, mesh)
    return tree_map(lambda leaf, spec: sharding.local_block(
        leaf, spec, mesh, coords), params, specs)


def _sample_logits() -> torch.Tensor:
    """Logits the rank sampler's unit check draws from: (B, padded
    vocab)."""
    V = _cfg(ARCHS[0]).padded_vocab
    return torch.from_numpy(np.random.default_rng(SEED + 1)
                            .standard_normal((B, V), np.float32) * 3)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(inputs, the ranks' results by rank, the reference's outputs, the
    port models by job): the reference runs in its subprocess while the
    ranks run here."""
    tmp = tmp_path_factory.mktemp("model_ranks")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = subprocess_env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    code = (f"ARCHS = {ARCHS!r}\nJOBS = {JOBS!r}\n"
            f"CACHED = {CACHED!r}\nVARIANTS = {VARIANTS!r}\n"
            f"MESH = {MESH!r}\n"
            f"B, S, PROMPT, STEPS = {B}, {S}, {PROMPT}, {STEPS!r}\n"
            f"ATTN_S = {ATTN_S!r}\nLOCAL = {LOCAL!r}\n"
            f"SEED = {SEED}\n"
            + textwrap.dedent(REFERENCE))
    proc = subprocess.Popen([sys.executable, "-c", code,
                             str(tmp / "in.npz"), str(tmp / "ref.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mesh = make_mesh(MESH, ("data", "model"))
        models = {job: _port_model(*job.split("/")) for job in JOBS}
        args = [([(job, m.cfg, _blocks(m, mesh, mesh.coords(r)),
                   _batch(job, inp), _steps(job))
                  for job, m in models.items()], PROMPT, _sample_logits())
                for r in range(mesh.size)]
        res = ranks.launch(_model_rank_worker.model_body, mesh, args,
                           init_file=str(tmp / "init"), timeout=DEADLINE)
        _, err = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with np.load(tmp / "ref.npz") as f:
        ref = dict(f)
    return inp, res, ref, models


def _block(arr, rows, m, M):
    """The (rows, vocab block m of M) block of a logits array."""
    Vl = arr.shape[-1] // M
    return arr[rows[0]:rows[1], ..., m * Vl:(m + 1) * Vl]


@pytest.mark.parametrize("job", JOBS)
def test_prefill_logits_match_reference(both, job):
    _, res, ref, _ = both
    want = ref[f"{job}/logits"]
    for r in res:
        got = r[job]
        np.testing.assert_allclose(
            got["logits"], _block(want, got["rows"], got["coords"][1],
                                  MESH[1]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("job", JOBS)
def test_greedy_tokens_match_reference(both, job):
    """Every rank returns the whole batch's greedy tokens, the
    reference's; its logits block after the prompt matches too."""
    _, res, ref, _ = both
    for r in res:
        got = r[job]
        np.testing.assert_array_equal(got["tokens"], ref[f"{job}/tokens"])
        np.testing.assert_allclose(
            got["dec_logits"], _block(ref[f"{job}/dec_logits"], got["rows"],
                                      got["coords"][1], MESH[1]),
            atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("job", JOBS)
def test_sampled_tokens_match_the_one_device_engine(both, job):
    """Decoding at temperature 1.0 gives every rank the whole batch's
    tokens of the one-device port engine seeded alike, on the same
    weights and prompt."""
    inp, res, _, models = both
    model = models[job]
    prompt = {k: v[:, :PROMPT] for k, v in _batch(job, inp).items()
              if k != "positions"}
    steps = _steps(job)
    eng = ServeEngine(model, max_len=PROMPT + steps, batch_size=B,
                      cache_dtype=torch.float32, device="cpu")
    eng.generator.manual_seed(_model_rank_worker.SAMPLE_SEED)
    first = model.argmax(eng.prefill(prompt))
    want = np.concatenate([first[:, None].numpy(), eng.decode(
        steps - 1, temperature=1.0, first_tokens=first).tokens], axis=1)
    for r in res:
        np.testing.assert_array_equal(r[job]["sampled"], want)


def test_rank_sampler_is_the_one_device_sampler(both):
    """``RankModel.sample`` on each rank's block (rows, vocab block) of
    the same logits draws ``Model.sample``'s tokens from a generator
    seeded alike, on every rank."""
    _, res, _, _ = both
    gen = torch.Generator().manual_seed(_model_rank_worker.SAMPLE_SEED)
    want = Model.sample(_sample_logits(), 1.0, gen).numpy()
    for r in res:
        np.testing.assert_array_equal(r["sampler"], want)


@pytest.mark.parametrize("job", JOBS)
def test_routes_are_the_flash_route(both, job):
    """Prefill is one kernel-11 call an attention layer on each rank (its
    plain version on the CPU), never the masked route, unless a softcap
    or a window past the sequence's first takes the masked route in every
    layer; decode combines the sequence-sharded cache (the "W" ring's
    slots too); Mamba-2 layers take no attention route."""
    _, res, _, _ = both
    cfg = _cfg(*job.split("/"))
    steps = PROMPT + 2 * (_steps(job) - 1) + 1
    attention = sum(cfg.layers.count(k) for k in "AWM")
    mla = cfg.layers.count("L")
    for r in res:
        got = r[job]
        if mla:
            assert got["routes"]["mla_blockwise:torch"] == mla
            assert got["routes"]["mla_decode_ranked:torch"] == steps * mla
        if not attention:
            assert got["op_paths"] == {}
            assert not any(k.startswith(("flash", "masked", "decode"))
                           for k in got["routes"])
        elif cfg.attn_logit_softcap:
            assert got["op_paths"] == {}
            assert got["routes"]["masked_blockwise:torch"] == \
                cfg.num_layers
            assert not any(k.startswith("flash") for k in got["routes"])
        else:
            assert got["op_paths"] == {"flash_attention": dispatch.TORCH_CPU}
            assert got["routes"]["flash_attention:torch-cpu"] == attention
            assert not any(k.startswith("masked") for k in got["routes"])
        if attention:
            assert got["routes"]["decode_ranked:torch"] == steps * attention


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("job", JOBS)
def test_sent_bytes_equal_dry_run_count(both, job, kind):
    """Each rank sends, by kind, what ``dryrun.count_rank_forward``
    counts for the same forward at its coordinates."""
    _, res, _, _ = both
    cfg = _cfg(*job.split("/"))
    mesh = make_mesh(MESH, ("data", "model"))
    shape = ShapeSpec("x", kind, S, B)
    for r in res:
        got = r[job]
        with dispatch.dry_run():
            want = dryrun.count_rank_forward(cfg, shape, mesh,
                                             tuple(got["coords"]))
        assert got[f"sent_{kind}"] == want["collectives"], got["coords"]
        assert set(want["collectives"]) == {"all-gather", "all-reduce"}


@pytest.mark.parametrize("Sa", ATTN_S)
def test_stripes_match_reference_rows(both, Sa):
    """``flash_attention_plain`` on stripe m's rows (zero rows for the
    padding) equals the reference's striped ``blockwise_attention`` at
    those rows' positions; a stripe count of 1 is every row in order."""
    inp, _, ref, _ = both
    cfg = _cfg(ARCHS[0])
    q, k, v = (torch.from_numpy(inp[f"{x}{Sa}"]) for x in "qkv")
    M = MESH[1]
    covered = []
    for m in range(M):
        st = ranked.seq_stripe(cfg, Sa, M, m)
        stripe = (st["bq"], M, m)
        pos = stripe_positions(st["rows"], stripe)[:st["valid"]]
        qs = torch.zeros((q.shape[0], st["rows"]) + q.shape[2:])
        qs[:, :st["valid"]] = q[:, pos]
        got = flash_attention_plain(qs, k, v, stripe=stripe)
        np.testing.assert_allclose(got[:, :st["valid"]].numpy(),
                                   ref[f"attn{Sa}"][:, pos.numpy()],
                                   atol=ATOL, rtol=RTOL)
        covered += pos.tolist()
    assert sorted(covered) == list(range(Sa))
    for seg in (ranked.seq_stripe(cfg, Sa, M, 0)["bq"], 7):
        np.testing.assert_allclose(
            flash_attention_plain(q, k, v, stripe=(seg, 1, 0)).numpy(),
            ref[f"attn{Sa}"], atol=ATOL, rtol=RTOL)


def test_local_stripes_match_reference_rows(both):
    """``layers.local_attention_stripe`` on stripe m's rows of every
    window (zero rows for the padding) equals the reference's
    ``_local_attention`` - windows folded into the batch, each window's
    Q tiles striped over "model", softcapped - at those rows; the stripes
    cover the sequence, and their rows equal the port's one-device
    ``local_attention``."""
    inp, _, ref, _ = both
    Sl, W, cap = LOCAL
    cfg = _cfg(ARCHS[0]).scaled(local_window=W, attn_logit_softcap=cap)
    q, k, v = (torch.from_numpy(inp[f"{x}{Sl}"]) for x in "qkv")
    one = layers.local_attention(q, k, v, cfg)
    M, nW = MESH[1], -(-Sl // W)
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nW * W - Sl))
    covered = []
    for m in range(M):
        st = ranked.seq_stripe(cfg, W, M, m)
        stripe = (st["bq"], M, m)
        pos = stripe_positions(st["rows"], stripe)[:st["valid"]]
        qs = torch.zeros((q.shape[0], nW, st["rows"]) + q.shape[2:])
        qs[:, :, :st["valid"]] = qp.unflatten(1, (nW, W))[:, :, pos]
        got = layers.local_attention_stripe(qs, k, v, cfg, stripe)
        rows = (torch.arange(nW)[:, None] * W + pos[None, :]).flatten()
        got = got[:, :, :st["valid"]].flatten(1, 2)[:, rows < Sl]
        rows = rows[rows < Sl]
        np.testing.assert_allclose(got.numpy(), ref["local"][:, rows.numpy()],
                                   atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(got, one[:, rows], atol=ATOL, rtol=RTOL)
        covered += rows.tolist()
    assert sorted(covered) == list(range(Sl))


def test_one_stripe_is_the_unstriped_call():
    """A stripe count of 1 is today's call bit for bit, a stripe holds
    the causal rows of the positions it names, and a stripe's backward
    gives autograd's gradients through the plain version with the same
    stripe (training across ranks; ``tests/test_torch_train_ranks.py``
    holds it further)."""
    g = torch.Generator().manual_seed(SEED)
    q = torch.randn((2, 96, 4, 16), generator=g)
    k, v = (torch.randn((2, 96, 2, 16), generator=g) for _ in range(2))
    want = flash_attention_plain(q, k, v)
    for stripe in ((32, 1, 0), (7, 1, 0), None):
        assert torch.equal(flash_attention_plain(q, k, v, stripe=stripe),
                           want)
        assert torch.equal(flash_attention(q, k, v, stripe=stripe), want)
    pos = stripe_positions(48, (16, 2, 1))
    assert pos.tolist() == list(range(16, 32)) + list(range(48, 64)) \
        + list(range(80, 96))
    got = flash_attention_plain(q[:, pos], k, v, stripe=(16, 2, 1))
    assert torch.equal(got, want[:, pos])
    with pytest.raises(ValueError):
        flash_attention_plain(q, k, v, stripe=(16, 2, 2))
    qs = q[:, pos].clone().requires_grad_()
    flash_attention(qs, k, v, stripe=(16, 2, 1)).square().sum().backward()
    qp = q[:, pos].clone().requires_grad_()
    flash_attention_plain(qp, k, v, stripe=(16, 2, 1)).square().sum() \
        .backward()
    torch.testing.assert_close(qs.grad, qp.grad, atol=ATOL, rtol=RTOL)


def test_one_by_one_mesh_is_the_one_device_model():
    """On a 1 x 1 mesh ``RankModel`` is ``Model`` on the rank's blocks
    (the whole leaves, not copies): prefill logits and greedy tokens bit
    for bit, for a dense and each MoE arch."""
    tokens = torch.from_numpy(_inputs()["tokens"]).long()
    mesh = make_host_mesh()
    for arch in [ARCHS[0]] + [job.split("/")[0] for job in MOE]:
        model = _port_model(arch)
        blocks = _blocks(model, mesh, (0, 0))
        rm = ranked.RankModel(model.cfg, blocks,
                              counting_comms(mesh, (0, 0)))
        assert torch.equal(rm.apply({"tokens": tokens}),
                           model.apply({"tokens": tokens}))
        np.testing.assert_array_equal(
            greedy_generate(rm, tokens[:, :PROMPT], _steps(arch)),
            greedy_generate(model, tokens[:, :PROMPT], _steps(arch)))
        ours = dict(rm._one.named_parameters())
        for name, p in model.named_parameters():
            assert ours[name].data_ptr() == p.data_ptr(), (arch, name)


@pytest.mark.parametrize("job", RECURRENT)
def test_recurrent_cache_blocks_match_reference(both, job):
    """After the greedy decode each rank's cache block, every leaf (the
    RG-LRU "h" and "conv" states of its channels, the Mamba-2 "ssm" state
    of its heads and its block of the packed conv state, a "W" layer's
    ring slice), is the same block of the reference's cache placed by
    ``cache_specs``."""
    _cache_blocks_match(both, job)


@pytest.mark.parametrize("job", MLA)
def test_mla_cache_blocks_match_reference(both, job):
    """After the greedy decode each rank's block of the latent cache, its
    batch rows and its contiguous slice of the slots ("latent" and
    "k_rope" by ``cache_specs``; every slot where the model positions do
    not divide them), is the same block of the reference's; the decode
    wrote slots on both model positions' slices (the prompt alone
    crosses the boundary)."""
    _cache_blocks_match(both, job)
    _, res, _, _ = both
    written = PROMPT + _steps(job) - 1
    for r in res:
        lat = r[job]["cache"]["blocks/0/latent"]       # (R, rows, slots, r)
        slots = lat.shape[2]
        mine = written
        if slots != PROMPT + _steps(job):              # a slice of them
            assert written > slots
            mine = min(slots, max(0, written - r[job]["coords"][1] * slots))
        assert mine > 0
        assert (np.abs(lat[:, :, :mine]).sum(-1) > 0).all()
        assert not lat[:, :, mine:].any()


def _cache_blocks_match(both, job):
    _, res, ref, _ = both
    cfg = _cfg(*job.split("/"))
    mesh = make_mesh(MESH, ("data", "model"))
    with dispatch.dry_run():
        meta = Model(cfg, device="meta")
    shapes = meta.cache_tree(meta.init_cache(B, PROMPT + _steps(job),
                                             torch.float32))
    specs = {path_str(k): s for k, s in leaves_with_path(
        sharding.cache_specs(cfg, shapes, mesh))}
    for r in res:
        got = r[job]
        assert sorted(got["cache"]) == sorted(specs)
        for name, x in got["cache"].items():
            want = sharding.local_block(torch.from_numpy(
                ref[f"{job}/cache/{name}"]), specs[name], mesh,
                got["coords"]).numpy()
            np.testing.assert_allclose(x, want, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{got['coords']} {name}")


def test_mamba2_heads_must_split():
    """A Mamba-2 head count that the model axis does not divide raises a
    ``ValueError``, as a ``d_ff`` or an RG-LRU width would."""
    cfg = get_reduced("mamba2-370m").scaled(vocab_size=768)
    mesh = make_mesh((1, 3), ("data", "model"))
    with pytest.raises(ValueError, match="head count 8 does not split"):
        ranked.RankModel(cfg, {}, counting_comms(mesh, (0, 1)))


def test_mla_config_needs_d_ff_to_split():
    """An MLA config takes a head count that the model axis does not
    divide (its head leaves stay whole), but a ``d_ff`` that it does not
    divide still raises a ``ValueError``."""
    cfg = get_reduced("minicpm3-4b").scaled(d_ff=96, vocab_size=768)
    mesh = make_mesh((1, 3), ("data", "model"))
    assert cfg.num_heads % 3
    ranked.RankModel(cfg, {}, counting_comms(mesh, (0, 1)))
    with pytest.raises(ValueError, match="d_ff 128 does not split"):
        ranked.RankModel(cfg.scaled(d_ff=128), {},
                         counting_comms(mesh, (0, 1)))


@pytest.mark.parametrize("arch", ("minicpm3-4b", "minicpm3-h3"))
def test_whole_head_decode_gathers_no_query(arch):
    """A decode step of an MLA config on (4, 2), counted on ``meta``: with
    4 heads each model position absorbs its 2 heads' queries and the
    model column all-gathers them (width r + rope); with 3 heads
    ("minicpm3-h3") no block of that width moves, every position
    computes every head's query, absorption and ``w_uv`` up-projection,
    which ``repeated`` names, and its ``wo`` block is 24 flat rows."""
    cfg = _cfg(arch)
    mesh = make_mesh(MESH, ("data", "model"))
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    with dispatch.dry_run():
        local, _ = dryrun._rank_blocks(cfg, mesh, (1, 1))
        comms = ranks.AxisComms(ranks.CountingComm(mesh, (1, 1), "data"),
                                _model_rank_worker.ShapeComm(mesh, (1, 1),
                                                             "model"))
        model = ranked.RankModel(cfg, local, comms)
        tokens = torch.zeros((B, 1), dtype=torch.long, device="meta")
        model.decode_step(model.init_cache(B, S), tokens[:, 0], S - 1)
    gathered = [shape for shape, _ in comms.model.gathered]
    widths = {shape[-1] for shape in gathered}
    mla = cfg.layers.count("L")
    if cfg.num_heads % MESH[1]:
        assert width not in widths
        assert {"w_uq", "w_uk", "w_uv"} <= set(model.repeated)
        assert local["blocks"][0]["mla"]["wo"].parts[0].shape[0] == 24
    else:
        assert len([s for s in gathered if s[-1] == width]) == mla
        assert not {"w_uq", "w_uk", "w_uv"} & set(model.repeated)
    # the partials: (rows, H, 1, r + 2) a layer
    partials = (B // MESH[0], cfg.num_heads, 1, cfg.kv_lora_rank + 2)
    assert gathered.count(partials) == mla


@pytest.mark.parametrize("Sa", ATTN_S)
def test_mla_stripes_match_reference_rows(both, Sa):
    """``layers._mla_blockwise`` on stripe m's rows (zero rows for the
    padding) against every key equals the reference's ``_mla_blockwise``
    under the (4, 2) mesh at those rows' positions (at S 80: 4 Q tiles of
    32 rows, the last all padding, and 2 KV tiles of 64); the stripes
    cover the sequence; a stripe count of 1 is the unstriped call bit
    for bit."""
    inp, _, ref, _ = both
    cfg = _cfg(MLA[0].split("/")[0])
    qn, qr, lat, kr = (torch.from_numpy(inp[f"mla_{x}{Sa}"])
                       for x in ("qn", "qr", "lat", "kr"))
    p = SimpleNamespace(w_uk=torch.from_numpy(inp["mla_w_uk"]),
                        w_uv=torch.from_numpy(inp["mla_w_uv"]))
    want = ref[f"mla{Sa}"]
    M = MESH[1]
    covered = []
    for m in range(M):
        st = ranked.seq_stripe(cfg, Sa, M, m)
        stripe = (st["bq"], M, m)
        pos = stripe_positions(st["rows"], stripe)[:st["valid"]]
        q = [torch.zeros((2, st["rows"]) + x.shape[2:]) for x in (qn, qr)]
        q[0][:, :st["valid"]], q[1][:, :st["valid"]] = qn[:, pos], qr[:, pos]
        got = layers._mla_blockwise(*q, lat, kr, p, cfg, stripe=stripe)
        np.testing.assert_allclose(got[:, :st["valid"]].numpy(),
                                   want[:, pos.numpy()], atol=ATOL, rtol=RTOL)
        covered += pos.tolist()
    assert sorted(covered) == list(range(Sa))
    one = layers._mla_blockwise(qn, qr, lat, kr, p, cfg)
    np.testing.assert_allclose(one.numpy(), want, atol=ATOL, rtol=RTOL)
    for seg in (ranked.seq_stripe(cfg, Sa, M, 0)["bq"], 7):
        assert torch.equal(layers._mla_blockwise(qn, qr, lat, kr, p, cfg,
                                                 stripe=(seg, 1, 0)), one)


def test_expert_count_must_split():
    """An expert count that the model axis does not divide raises a
    ``ValueError`` (a rank owns E/M whole experts); the 1 x 1 mesh takes
    any."""
    cfg = get_reduced("kimi-k2-1t-a32b").scaled(num_experts=9)
    mesh = make_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="expert count 9 does not split"):
        ranked.RankModel(cfg, {}, counting_comms(mesh, (0, 1)))
    ranked.check_config(cfg, make_host_mesh())


@pytest.mark.parametrize("job", MOE)
def test_moe_routes_and_drops_are_the_one_device_model(both, job):
    """Each rank's prefill routes its batch rows as the one-device model
    routes them: every MoE layer's top-K experts and keep flags (the drop
    set) equal the one-device model's rows, exactly, and its dropped
    assignments their count; the batch drops some (the capacity binds at
    B 4 x S 64)."""
    inp, res, _, models = both
    model = models[job]
    moe.reset_drops()
    with moe.record_routes() as routes:
        model.apply(_batch(job, inp))
    n_moe = model.cfg.layers.count("M")
    assert len(routes) == len(routes.kept) == n_moe
    dropped = {}
    for r in res:
        got = r[job]
        r0, r1 = got["rows"]
        assert len(got["moe_routes"]) == len(got["moe_kept"]) == n_moe
        for i in range(n_moe):
            np.testing.assert_array_equal(got["moe_routes"][i],
                                          routes[i][r0:r1].numpy())
            np.testing.assert_array_equal(got["moe_kept"][i],
                                          routes.kept[i][r0:r1].numpy())
        assert got["drops"] == (sum(int((~k[r0:r1]).sum())
                                    for k in routes.kept),
                                (r1 - r0) * S * model.cfg.experts_per_token
                                * n_moe)
        dropped[got["rows"]] = got["drops"][0]
    assert sum(dropped.values()) == moe.dropped_assignments()[0] > 0


def test_batch_smaller_than_data_is_replicated(tmp_path):
    """B 1 on (2, 2): both data columns run the one row (``shard_act``'s
    demotion), at a ragged S of 70 whose second stripe is half padding;
    every rank's logits block and greedy tokens match the one-device
    model's."""
    mesh = make_mesh((2, 2), ("data", "model"))
    model = _port_model(ARCHS[0])
    tokens = torch.from_numpy(_inputs()["tokens"][:1, :70]).long()
    assert ranked.seq_stripe(model.cfg, 70, 2, 1)["valid"] == 32
    steps = _steps(ARCHS[0])
    args = [([("one", model.cfg, _blocks(model, mesh, mesh.coords(r)),
               {"tokens": tokens}, steps)], PROMPT)
            for r in range(mesh.size)]
    res = ranks.launch(_model_rank_worker.model_body, mesh, args,
                       init_file=str(tmp_path / "init"), timeout=DEADLINE)
    want = model.apply({"tokens": tokens}).numpy()
    eng = ServeEngine(model, max_len=PROMPT + steps, batch_size=1,
                      cache_dtype=torch.float32, device="cpu")
    first = model.argmax(eng.prefill({"tokens": tokens[:, :PROMPT]}))
    want_tokens = np.concatenate([first[:, None].numpy(), eng.decode(
        steps - 1, first_tokens=first).tokens], axis=1)
    for r in res:
        got = r["one"]
        assert tuple(got["rows"]) == (0, 1)
        np.testing.assert_allclose(got["logits"], _block(
            want, got["rows"], got["coords"][1], 2), atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(got["tokens"], want_tokens)


def test_batch_rows_follow_shard_act():
    """Batch rows: B / A a data position, every row when B < A (the
    reference's demotion to replicated); a batch above A that A does not
    divide raises (it would leave a data position no rows), in
    ``batch_rows`` and so in ``apply``, ``decode_step`` and
    ``init_cache`` alike."""
    assert [ranked.batch_rows(4, 4, a) for a in range(4)] == \
        [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert [ranked.batch_rows(8, 4, a) for a in range(4)] == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert ranked.batch_rows(1, 2, 1) == (0, 1)
    with pytest.raises(ValueError, match="batch of 6 on 4"):
        ranked.batch_rows(6, 4, 3)
    cfg = get_reduced(ARCHS[0])
    mesh = make_mesh((4, 2), ("data", "model"))
    rm = ranked.RankModel(cfg, {}, counting_comms(mesh, (3, 0)))
    tokens = torch.zeros((6, 16), dtype=torch.long)
    for call in (lambda: rm.apply({"tokens": tokens}),
                 lambda: rm.decode_step([], tokens[:, 0], 0),
                 lambda: rm.init_cache(6, 16)):
        with pytest.raises(ValueError, match="batch of 6 on 4"):
            call()


def test_every_config_field_is_read_or_refused():
    """Every ``ModelConfig`` field is one the rank path reads as
    ``Model`` does (every layer kind runs across ranks): a new option
    fails here until ``ranked`` says how it reads it."""
    assert ranked.unclassified_fields() == set()


def test_pod_mesh_and_uneven_batch_keep_the_even_split():
    """The dry run counts a rank on a (data, model) or (pod, data, model)
    mesh whose axes split the batch: a batch of 6 on 4 data positions
    keeps the even split, and the multi-pod mesh's decode cell (128 rows
    over its 2 x 16 (pod, data) positions) now counts a rank."""
    saved = dryrun.get_config
    dryrun.get_config = get_reduced
    try:
        cfg = get_reduced(ARCHS[0])
        shape = dryrun.cell_shape("prefill_32k", 6, 64)
        assert not dryrun.rank_counted(
            cfg, shape, make_mesh((4, 2), ("data", "model")))
        assert dryrun.rank_counted(
            cfg, dryrun.cell_shape("prefill_32k", 8, 64),
            make_mesh((4, 2), ("data", "model")))
        res = dryrun.run_cell(ARCHS[0], "decode_32k", "multi")
    finally:
        dryrun.get_config = saved
    assert res["status"] == "ok" and res["count"] == "rank"
    assert sorted(tuple(p["coords"]) for p in res["positions"]) == \
        [(0, 0, m) for m in range(16)]


def test_rank_counts_on_every_position():
    """The dry run's JSON for a rank cell names its count and the
    positions it counted."""
    saved = dryrun.get_config
    dryrun.get_config = get_reduced
    try:
        res = dryrun.run_cell("phi4-mini-3.8b", "decode_32k",
                              make_mesh((2, 2), ("data", "model")))
    finally:
        dryrun.get_config = saved
    json.dumps(res)
    assert res["count"] == "rank"
    assert sorted(tuple(p["coords"]) for p in res["positions"]) == \
        [(0, 0), (0, 1)]
    assert res["collectives"]["all-gather"] > 0
