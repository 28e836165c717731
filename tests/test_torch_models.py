"""The port's dense model, serving engine and launcher against the JAX
package's.

The reduced configs of the three dense archs (starcoder2-3b,
phi4-mini-3.8b, mistral-large-123b) run in float32 and in bfloat16 with
the reference's own weights, carried over by ``models.convert.
params_from_jax``; the same numpy tokens feed both sides.  On the CPU the
port's attention takes the flash kernel's plain version.  Tolerances:
``Model.apply`` and ``decode_step`` logits within 1e-4 in float32 and
2e-2 in bfloat16 (the reference's own decode test bound); greedy tokens
equal in float32.  The configs of all ten architectures equal the
reference's field by field.  Every option of a layer (a local window with
its ring cache, M-RoPE, embedding inputs, the int8 KV cache, a logit
softcap) on starcoder2-3b's reduced config, and ``blockwise_attention``
with a window, a ``q_offset`` or a ``kv_mask``, are held against the
reference at the same tolerances.  The other seven archs' twins are in
``test_torch_model_kinds.py``.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import subprocess_env
from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.models import Model as RefModel
from repro.models.layers import blockwise_attention as ref_blockwise
from repro.serve.engine import greedy_generate as ref_greedy_generate
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.kernels import launch_counts
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import blockwise_attention
from repro_torch.serve import ServeEngine, greedy_generate

torch.set_num_threads(1)

ARCH = "starcoder2-3b"
#: the archs whose every layer is "A" with token inputs, RoPE, a bf16 KV
#: cache and no softcap: what this port runs
DENSE = ("starcoder2-3b", "mistral-large-123b", "phi4-mini-3.8b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S = 2, 96


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape)


#: (arch, dtype) of the twins; starcoder2-3b's ids stay the dtype alone
TWINS = [(a, dt) for a in DENSE for dt in ("float32", "bfloat16")]


@pytest.fixture(scope="module", params=TWINS,
                ids=[dt if a == ARCH else f"{a}-{dt}" for a, dt in TWINS])
def twins(request):
    """(dtype, reference model, its params, the port's model with the
    same weights)."""
    arch, dtype = request.param
    ref_cfg = ref_get_reduced(arch).scaled(dtype=dtype)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(arch).scaled(dtype=dtype), device="cpu")
    params_from_jax(model, jax.tree.map(np.asarray, params))
    return dtype, ref, params, model


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_names_match():
    assert ARCH_NAMES == REF_ARCH_NAMES


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", REF_ARCH_NAMES)
def test_configs_equal_reference(arch, reduced):
    port = (get_reduced if reduced else get_config)(arch)
    ref = (ref_get_reduced if reduced else ref_get_config)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.layers, port.padded_vocab, port.param_count()) == \
        (ref.layers, ref.padded_vocab, ref.param_count())


@pytest.mark.parametrize("arch", [a for a in REF_ARCH_NAMES
                                  if a not in DENSE])
def test_model_builds_every_arch_as_the_reference(arch):
    """Every layer kind builds, and the parameter tree (``param_tree``)
    and the cache tree (``cache_tree``) have the reference's paths,
    shapes and dtypes."""
    from repro_torch.models.convert import param_tree
    from repro_torch.tree import leaves_with_path
    ref = RefModel(ref_get_reduced(arch))
    model = Model(get_reduced(arch), device="cpu")

    def ref_leaves(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return [(tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in p), tuple(x.shape), str(x.dtype))
                for p, x in flat]

    def port_leaves(tree):
        return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for p, x in leaves_with_path(tree)]

    want_p = ref_leaves(jax.eval_shape(ref.init, jax.random.PRNGKey(0)))
    want_c = ref_leaves(jax.eval_shape(lambda: ref.init_cache(2, 24)))
    assert port_leaves(param_tree(model)) == want_p
    assert port_leaves(model.cache_tree(model.init_cache(2, 24))) == want_c


#: each option of a layer on starcoder2-3b's reduced config, with what it
#: needs to run: a window shorter than the sequence (its ring wraps in
#: decode), M-RoPE sections summing to hd/2
OPTIONS = [("layer_pattern", "AW"), ("rope_kind", "mrope"),
           ("input_mode", "embeddings"), ("kv_cache_dtype", "int8"),
           ("attn_logit_softcap", 50.0)]
_OPTION_NEEDS = {"layer_pattern": dict(local_window=32),
                 "rope_kind": dict(mrope_sections=(2, 3, 3))}


@pytest.mark.parametrize("field,value", OPTIONS)
def test_model_options_match_reference(field, value):
    """``Model.apply`` and 96 ``decode_step``s in float32 within 1e-4 of
    the reference, each option on: embeddings feed both as (B, S, d) and
    (B, 1, d) steps, M-RoPE both with (3, B, S) positions whose streams
    differ, the int8 cache's bytes after the decode equal (its scales
    within 1e-6 relative)."""
    over = dict(dtype="float32", **{field: value},
                **_OPTION_NEEDS.get(field, {}))
    ref = RefModel(ref_get_reduced(ARCH).scaled(**over))
    params = ref.init(jax.random.PRNGKey(5))
    model = params_from_jax(Model(get_reduced(ARCH).scaled(**over),
                                  device="cpu"),
                            jax.tree.map(np.asarray, params))
    cfg = ref.cfg
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos3 = np.stack([np.arange(S)[None].repeat(B, 0) * f // 2
                     for f in (2, 1, 3)]).astype(np.int32)
    batch, tbatch = {}, {}
    if field == "input_mode":
        batch["embeddings"] = jnp.asarray(emb)
        tbatch["embeddings"] = torch.from_numpy(emb)
    else:
        batch["tokens"] = jnp.asarray(toks)
        tbatch["tokens"] = torch.from_numpy(toks)
    if field == "rope_kind":
        batch["positions"] = jnp.asarray(pos3)
        tbatch["positions"] = torch.from_numpy(pos3).long()
    want = np.asarray(ref.apply(params, batch))
    got = model.apply(tbatch).numpy()
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=0)

    cache = model.init_cache(B, S, dtype=torch.float32)
    ref_cache = ref.init_cache(B, S, dtype=jnp.float32)
    step = jax.jit(ref.decode_step)
    for t in range(S):
        if field == "input_mode":
            tok, ttok = jnp.asarray(emb[:, t:t + 1]), \
                torch.from_numpy(emb[:, t:t + 1])
        else:
            tok, ttok = jnp.asarray(toks[:, t]), torch.from_numpy(toks[:, t])
        pos = tpos = None
        if field == "rope_kind":
            pos = jnp.asarray(pos3[:, :, t:t + 1])
            tpos = torch.from_numpy(pos3[:, :, t:t + 1]).long()
        got, cache = model.decode_step(cache, ttok, t, positions=tpos)
        want, ref_cache = step(params, ref_cache, tok, jnp.int32(t), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL["float32"], rtol=0,
                                   err_msg=f"position {t}")
    if field == "kv_cache_dtype":
        # the int8 bytes equal; the fp32 scales follow K and V, which the
        # two packages' matrix products round apart by an ulp
        tree = model.cache_tree(cache)["blocks"][0]
        for name in ("k", "v", "k_scale", "v_scale"):
            got, want = tree[name].materialize().numpy(), \
                np.asarray(ref_cache["blocks"][0][name])
            if name.endswith("scale"):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


def test_model_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_reduced(ARCH))


@pytest.mark.parametrize("kw", [dict(window=8), dict(q_offset=4),
                                dict(kv_mask=True)])
def test_blockwise_attention_options_match_reference(kw):
    """The masked route (torch tiles, not kernel 11) against the
    reference's scan over several Q and KV tiles, fp32 within 1e-5."""
    rng = np.random.default_rng(len(repr(kw)))
    q = rng.standard_normal((2, 100, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 100, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 100, 2, 16)).astype(np.float32)
    if "kv_mask" in kw:
        mask = rng.random((2, 100)) < 0.7
        mask[:, 0] = True                  # every row keeps a key
        kw = dict(kv_mask=mask)
    cfg = get_reduced(ARCH).scaled(dtype="float32")
    want = np.asarray(ref_blockwise(
        *(jnp.asarray(a) for a in (q, k, v)), ref_get_reduced(ARCH).scaled(
            dtype="float32"), causal=True,
        **{n: jnp.asarray(x) if n == "kv_mask" else x for n, x in kw.items()}))
    got = blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), cfg, causal=True,
        **{n: torch.from_numpy(x) if n == "kv_mask" else x
           for n, x in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _ref_tree(dtype="float32"):
    ref = RefModel(ref_get_reduced(ARCH).scaled(dtype=dtype))
    return jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(1)))


def test_params_from_jax_places_every_leaf():
    tree = _ref_tree()
    model = params_from_jax(
        Model(get_reduced(ARCH).scaled(dtype="float32"), device="cpu"), tree)
    n_unit = len(model.unit)
    for r in range(model.repeats):
        for u in range(n_unit):
            layer = model.layers[r * n_unit + u]
            np.testing.assert_array_equal(
                layer.attn.wq.numpy(), tree["blocks"][u]["attn"]["wq"][r])
            np.testing.assert_array_equal(
                layer.mlp.w_down.numpy(),
                tree["blocks"][u]["mlp"]["w_down"][r])
    np.testing.assert_array_equal(model.embeddings.unembed.numpy(),
                                  tree["embeddings"]["unembed"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_params_from_jax_raises_on_mismatch(fault):
    tree = _ref_tree()
    # initialised: uninitialised memory may hold NaN, never equal to itself
    model = Model(get_reduced(ARCH).scaled(dtype="float32"),
                  device="cpu").init(torch.Generator().manual_seed(0))
    before = model.layers[0].attn.wq.clone()
    err = {"missing": KeyError, "extra": KeyError, "shape": ValueError,
           "dtype": TypeError}[fault]
    if fault == "missing":
        del tree["blocks"][0]["mlp"]["w_up"]
    elif fault == "extra":
        tree["blocks"][0]["mlp"]["bias"] = tree["blocks"][0]["mlp"]["w_up"]
    elif fault == "shape":
        tree["embeddings"]["embed"] = tree["embeddings"]["embed"][:-1]
    else:
        tree["final_norm"]["scale"] = tree["final_norm"]["scale"].astype(
            np.float64)
    with pytest.raises(err):
        params_from_jax(model, tree)
    assert torch.equal(model.layers[0].attn.wq, before), "partial copy"


# ---------------------------------------------------------------------------
# forward, decode, generation against the reference
# ---------------------------------------------------------------------------

def test_apply_matches_reference(twins):
    dtype, ref, params, model = twins
    toks = _tokens(ref.cfg.vocab_size, (B, S))
    want = np.asarray(ref.apply(params, {"tokens": jnp.asarray(toks)})
                      .astype(jnp.float32))
    got = model.apply({"tokens": torch.from_numpy(toks)})
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, S, ref.cfg.padded_vocab)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=0)


def test_decode_step_matches_reference(twins):
    dtype, ref, params, model = twins
    toks = _tokens(ref.cfg.vocab_size, (B, S), seed=1)
    cache = model.init_cache(B, S, dtype=torch.float32)
    ref_cache = ref.init_cache(B, S, dtype=jnp.float32)
    step = jax.jit(ref.decode_step)
    for t in range(S):
        got, cache = model.decode_step(cache, torch.from_numpy(toks[:, t]), t)
        want, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            atol=TOL[dtype], rtol=0, err_msg=f"position {t}")


def test_greedy_generate_matches_reference():
    ref = RefModel(ref_get_reduced(ARCH).scaled(dtype="float32"))
    params = ref.init(jax.random.PRNGKey(2))
    model = params_from_jax(
        Model(get_reduced(ARCH).scaled(dtype="float32"), device="cpu"),
        jax.tree.map(np.asarray, params))
    prompt = _tokens(ref.cfg.vocab_size, (2, 8), seed=2)
    want = ref_greedy_generate(ref, params, jnp.asarray(prompt), steps=6)
    got = greedy_generate(model, torch.from_numpy(prompt), steps=6)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Sequential decode == teacher-forced forward (the twin of
    tests/test_models.py::test_decode_matches_forward), bf16 activations,
    fp32 cache."""
    gen = torch.Generator().manual_seed(0)
    model = Model(get_reduced(arch), device="cpu").init(gen)
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (B, S), seed=3))
    full = model.apply({"tokens": toks}).float()
    cache = model.init_cache(B, S, dtype=torch.float32)
    for t in range(S):
        logits, cache = model.decode_step(cache, toks[:, t], t)
        err = float((logits.float() - full[:, t]).abs().max())
        assert err < 2e-2, (arch, t, err)


def test_cpu_forward_launches_no_kernel():
    gen = torch.Generator().manual_seed(0)
    model = Model(get_reduced(ARCH), device="cpu").init(gen)
    before = launch_counts()
    model.apply({"tokens": torch.zeros(1, 16, dtype=torch.long)})
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_engine_samples_deterministically():
    gen = torch.Generator().manual_seed(0)
    model = Model(get_reduced(ARCH), device="cpu").init(gen)
    prompt = torch.from_numpy(_tokens(model.cfg.vocab_size, (2, 5), seed=4))
    runs = []
    for _ in range(2):
        eng = ServeEngine(model, max_len=12, batch_size=2, device="cpu",
                          generator=torch.Generator().manual_seed(7))
        logits = eng.prefill({"tokens": prompt})
        res = eng.decode(7, temperature=1.0,
                         first_tokens=torch.argmax(logits, dim=-1))
        assert res.tokens.shape == (2, 7) and eng.cur_len == 12
        assert ((res.tokens >= 0) & (res.tokens < model.cfg.padded_vocab)
                ).all()
        runs.append(res.tokens)
    np.testing.assert_array_equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="cache"):
        eng.decode(1, first_tokens=torch.zeros(2, dtype=torch.long))


def _serve(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=subprocess_env(), capture_output=True, text=True, timeout=300)


def test_launch_serve_reduced_on_cpu():
    out = _serve("--reduced", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "prefill 4x32 in" in out.stdout and "tok/s" in out.stdout


def test_launch_serve_protect_recovers_cache_pages():
    """``--protect`` erasure-codes the KV cache pages, refreshes their
    parity after the decode and rebuilds data position 0's pages, which
    equal the live ones."""
    out = _serve("--reduced", "--device", "cpu", "--protect")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "cache pages EC-protected" in out.stdout
    assert "equal the live cache: True" in out.stdout
