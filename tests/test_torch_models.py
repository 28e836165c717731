"""The port's dense model, serving engine and launcher against the JAX
package's.

starcoder2-3b's reduced config runs in float32 and in bfloat16 with the
reference's own weights, carried over by ``models.convert.
params_from_jax``; the same numpy tokens feed both sides.  On the CPU the
port's attention takes the flash kernel's plain version.  Tolerances:
``Model.apply`` and ``decode_step`` logits within 1e-4 in float32 and
2e-2 in bfloat16 (the reference's own decode test bound); greedy tokens
equal in float32.  The configs of all ten architectures equal the
reference's field by field.
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


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def twins(request):
    """(dtype, reference model, its params, the port's model with the
    same weights)."""
    dtype = request.param
    ref_cfg = ref_get_reduced(ARCH).scaled(dtype=dtype)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(ARCH).scaled(dtype=dtype), device="cpu")
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
def test_model_raises_for_unported_archs(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(get_reduced(arch), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("layer_pattern", "AW"), ("rope_kind", "mrope"),
    ("input_mode", "embeddings"), ("kv_cache_dtype", "int8"),
    ("attn_logit_softcap", 50.0)])
def test_model_raises_for_unported_options(field, value):
    cfg = get_reduced(ARCH).scaled(**{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, device="cpu")


def test_model_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_reduced(ARCH))


@pytest.mark.parametrize("kw", [dict(window=8), dict(q_offset=4),
                                dict(kv_mask=torch.ones(1, 8, dtype=bool))])
def test_blockwise_attention_raises_outside_the_slice(kw):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        blockwise_attention(q, k, k, get_reduced(ARCH), **kw)


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
