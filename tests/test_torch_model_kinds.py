"""Whole-model twins of the archs beyond the dense three: the port's
``Model.apply`` and ``decode_step`` against the JAX package's, with the
reference's own weights (``models.convert.params_from_jax``) and the same
numpy inputs.

recurrentgemma-2b (RG-LRU + local attention: its prefill of 96 tokens
folds windows of 64, its 80 decode steps wrap the ring), qwen2-vl-7b
(M-RoPE, embedding inputs, (3, B, S) positions whose streams differ),
musicgen-medium (embedding inputs) and minicpm3-4b (MLA) here;
mamba2-370m, llama4-maverick-400b-a17b and kimi-k2-1t-a32b (MoE) in
``test_torch_model_moe.py``.

Tolerances: logits within 1e-4 in float32 and 2e-2 in bfloat16 (the
reference's own decode test bound).  In MoE configs the routing choices
of every layer are compared first and the share that agrees is printed.
In float32 they must agree at every token.  In bfloat16 a near-tie can
flip a choice: a token whose choice differs in any layer must be one
where the reference's K-th and next router probabilities lie within
``NEAR_TIE`` of each other (relative).  A flip moves the capacity slots
of the tokens after it in its row, so a token whose kept-or-dropped
state differs is affected too; the flipped and the affected tokens'
logits are left out of the 2e-2 check and printed, and every other
position is held to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models import Model as RefModel
from repro_torch.configs import get_reduced
from repro_torch.models import Model
from repro_torch.models import moe as port_moe
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S = 2, 96
#: decode steps: past the reduced window (64) for recurrentgemma-2b
STEPS = {"recurrentgemma-2b": 80}
DEFAULT_STEPS = 12
#: a near-tie of the router: the K-th and next probabilities within 1 %
#: of each other (bf16 carries 8 bits, a relative step of 0.4 %)
NEAR_TIE = 1e-2


def _inputs(cfg, seed):
    """Numpy inputs for a prefill of (B, S): tokens or embeddings, and
    (3, B, S) M-RoPE positions whose t, h, w streams differ."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    if cfg.rope_kind == "mrope":
        t = np.arange(S)[None].repeat(B, 0)
        out["positions"] = np.stack([t, t // 2, (t * 3) // 2]).astype(
            np.int32)
    return out


def _ref_batch(inp, dtype):
    out = {k: jnp.asarray(v) for k, v in inp.items()}
    if "embeddings" in out:
        out["embeddings"] = out["embeddings"].astype(dtype)
    return out


def _port_batch(inp):
    out = {k: torch.from_numpy(v) for k, v in inp.items()}
    if "positions" in out:
        out["positions"] = out["positions"].long()
    return out


def _ref_apply_routed(ref, params, batch, monkeypatch):
    """The reference's ``apply`` logits, and its router at every MoE layer
    in that same call: (top-K experts (B, S, K), probabilities (B, S, E))
    per layer, recorded from ``jax.lax.top_k`` inside the scan by an
    ordered debug callback."""
    seen = []
    real = jax.lax.top_k

    def record(idx, probs):
        seen.append((np.asarray(idx), np.asarray(probs)))

    def top_k(x, k):
        vals, idx = real(x, k)
        jax.debug.callback(record, idx, x, ordered=True)
        return vals, idx

    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "top_k", top_k)
        logits = ref.apply(params, batch)
        jax.effects_barrier()
    return np.asarray(logits.astype(jnp.float32)), seen


def _kept(top_e, cfg):
    """(B, S, K) bool: which assignments keep their capacity slot, as
    ``moe_apply`` decides (a stable sort by expert, ``cap`` slots
    each)."""
    Bn, Sn, K = top_e.shape
    cap = max(int(np.ceil(Sn * K / cfg.num_experts
                          * cfg.moe_capacity_factor)), 4)
    flat = top_e.reshape(Bn, Sn * K)
    kept = np.zeros(flat.shape, bool)
    for b in range(Bn):
        seen = np.zeros(cfg.num_experts, int)
        for i in np.argsort(flat[b], kind="stable"):
            kept[b, i] = seen[flat[b, i]] < cap
            seen[flat[b, i]] += 1
    return kept.reshape(Bn, Sn, K)


def run_twin(arch, dtype, monkeypatch):
    ref = RefModel(ref_get_reduced(arch).scaled(dtype=dtype))
    params = ref.init(jax.random.PRNGKey(0))
    model = params_from_jax(Model(get_reduced(arch).scaled(dtype=dtype),
                                  device="cpu"),
                            jax.tree.map(np.asarray, params))
    cfg = ref.cfg
    inp = _inputs(cfg, seed=1)
    rbatch, pbatch = _ref_batch(inp, dtype), _port_batch(inp)

    tol = TOL[dtype]
    flipped = np.zeros((B, S), bool)
    if "M" in cfg.layers:
        routes = []
        real = port_moe.route

        def spy(p, x, c):
            top_w, top_e = real(p, x, c)
            routes.append(top_e.numpy())
            return top_w, top_e
        with monkeypatch.context() as mp:
            mp.setattr(port_moe, "route", spy)
            model.apply(pbatch)
        want, want_routes = _ref_apply_routed(ref, params, rbatch,
                                              monkeypatch)
        assert len(routes) == len(want_routes) == cfg.layers.count("M")
        same = [(np.sort(g, -1) == np.sort(w, -1)).all(-1)
                for g, (w, _) in zip(routes, want_routes)]
        agree = [float(s.mean()) for s in same]
        print(f"{arch} {dtype}: routing agrees at {agree} of tokens")
        for lay, (s_, (w, probs)) in enumerate(zip(same, want_routes)):
            for b, t in np.argwhere(~s_):
                top = np.sort(probs[b, t])[::-1]
                K = cfg.experts_per_token
                gap = (top[K - 1] - top[K]) / top[K - 1]
                print(f"  layer {lay} (b {b}, t {t}): port {routes[lay][b, t]}"
                      f", reference {w[b, t]}; reference probabilities "
                      f"{top[K - 1]} (K-th) vs {top[K]} (next)")
                assert dtype == "bfloat16" and gap < NEAR_TIE, \
                    (arch, dtype, lay, b, t, gap)
                flipped[b, t] = True
            kept_differs = (_kept(routes[lay], cfg)
                            != _kept(w, cfg)).any(-1)
            flipped |= kept_differs

    else:
        want = np.asarray(ref.apply(params, rbatch).astype(jnp.float32))
    got = model.apply(pbatch)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, S, cfg.padded_vocab)
    diff = np.abs(got.float().numpy() - want).max(-1)          # (B, S)
    err = float(diff[~flipped].max())
    print(f"{arch} {dtype}: apply max |port - reference| {err} over "
          f"{int((~flipped).sum())} positions; at the {int(flipped.sum())} "
          f"with a flipped route {diff[flipped].tolist()}")
    assert err <= tol, (arch, dtype, err, tol)

    steps = STEPS.get(arch, DEFAULT_STEPS)
    cache = model.init_cache(B, steps, dtype=torch.float32)
    ref_cache = ref.init_cache(B, steps, dtype=jnp.float32)
    step = jax.jit(ref.decode_step)
    worst = 0.0
    for t in range(steps):
        if "embeddings" in inp:
            e = inp["embeddings"][:, t:t + 1]
            tok, ptok = jnp.asarray(e).astype(dtype), torch.from_numpy(e)
        else:
            tok = jnp.asarray(inp["tokens"][:, t])
            ptok = torch.from_numpy(inp["tokens"][:, t])
        pos = ppos = None
        if "positions" in inp:
            p = inp["positions"][:, :, t:t + 1]
            pos, ppos = jnp.asarray(p), torch.from_numpy(p).long()
        got, cache = model.decode_step(cache, ptok, t, positions=ppos)
        want, ref_cache = step(params, ref_cache, tok, jnp.int32(t), pos)
        err = np.abs(got.float().numpy()
                     - np.asarray(want.astype(jnp.float32))).max(-1)
        err = float(err[~flipped[:, t]].max(initial=0.0))
        worst = max(worst, err)
        assert err <= tol, (arch, dtype, t, err, tol)
    print(f"{arch} {dtype}: {steps} decode steps, max |port - reference| "
          f"{worst}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-vl-7b",
                                  "musicgen-medium", "minicpm3-4b"])
def test_model_kind_matches_reference(arch, dtype, monkeypatch):
    run_twin(arch, dtype, monkeypatch)
