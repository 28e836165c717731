"""Serving every arch: the port's ``launch.serve`` and ``ServeEngine``
against the JAX package's.

* ``launch.serve --reduced --device cpu --arch <a>`` runs for each of the
  ten archs and prints its prefill, decode and attention routes;
* ``greedy_generate`` with the reference's own weights (fp32) gives the
  reference's tokens for each arch (prompts through the prefill's token
  by token decode, embeddings configs through their table, as the
  reference's launcher feeds them);
* an embeddings prompt fed to ``ServeEngine.prefill`` gives the logits of
  ``Model.apply`` at its last position (fp32, 1e-4);
* ``--protect`` on recurrentgemma-2b rebuilds pages equal to the live
  cache (its W ring plus the RG-LRU states);
* the reference's recurrentgemma-2b serving cache, copied into the
  port's engine, gives the reference's pages, parity and rebuilt pages
  byte for byte over RS(3,2) on a (4, 1) mesh (the reference's
  ``examples/serve_degraded.py`` setup), from one subprocess with 4 host
  devices.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import subprocess_env
from repro.configs import ARCH_NAMES
from repro.configs import get_reduced as ref_get_reduced
from repro.models import Model as RefModel
from repro.serve.engine import greedy_generate as ref_greedy_generate
from repro_torch.configs import get_reduced
from repro_torch.distributed import ecstore, sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine, greedy_generate
from repro_torch.tree import leaves

torch.set_num_threads(1)

HYBRID = "recurrentgemma-2b"


def _serve(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=subprocess_env(), capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launch_serve_runs_every_arch_on_cpu(arch):
    out = _serve("--reduced", "--device", "cpu", "--arch", arch,
                 "--batch", "2", "--prompt-len", "8", "--gen", "8")
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"{arch} (reduced" in out.stdout
    assert "prefill 2x8 in" in out.stdout and "tok/s" in out.stdout
    assert "attention routes:" in out.stdout


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_greedy_generate_matches_reference(arch):
    ref = RefModel(ref_get_reduced(arch).scaled(dtype="float32"))
    params = ref.init(jax.random.PRNGKey(2))
    model = params_from_jax(
        Model(get_reduced(arch).scaled(dtype="float32"), device="cpu"),
        jax.tree.map(np.asarray, params))
    prompt = np.random.default_rng(2).integers(0, ref.cfg.vocab_size, (2, 8))
    want = ref_greedy_generate(ref, params, jnp.asarray(prompt), steps=6)
    got = greedy_generate(model, torch.from_numpy(prompt), steps=6)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_prefill_takes_embeddings(arch):
    cfg = get_reduced(arch).scaled(dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    emb = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32))
    eng = ServeEngine(model, max_len=12, batch_size=2, device="cpu",
                      cache_dtype=torch.float32)
    logits = eng.prefill({"embeddings": emb})
    assert eng.cur_len == 10
    full = model.apply({"embeddings": emb})
    torch.testing.assert_close(logits, full[:, -1], atol=1e-4, rtol=0)


def test_launch_serve_protect_rebuilds_the_hybrid_cache():
    out = _serve("--reduced", "--device", "cpu", "--arch", HYBRID,
                 "--protect")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "cache pages EC-protected" in out.stdout
    assert "equal the live cache: True" in out.stdout


_REFERENCE = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_reduced
from repro.distributed import sharding as shd
from repro.distributed.ecstore import ECConfig
from repro.launch.mesh import make_mesh
from repro.models import Model
from repro.serve.engine import ServeEngine
cfg = get_reduced("recurrentgemma-2b")
model = Model(cfg)
params = model.init(jax.random.PRNGKey(0))
eng = ServeEngine(model, params, max_len=48, batch_size=4)
toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 24))
eng.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
mesh = make_mesh((4, 1), ("data", "model"))
cspecs = shd.cache_specs(cfg, jax.eval_shape(lambda: eng.cache), mesh)
eng.protect_cache(mesh, cspecs, ECConfig(k=2, m=1, page_size=256))
out = {}
with mesh:
    out["pages"] = np.asarray(eng.ec_store.local_pages(eng.cache))
    out["parity"] = np.asarray(eng.ec_parity)
    for fail in (0, 3):
        out[f"recover{fail}"] = np.asarray(eng.recover_cache_pages(fail))
for i, leaf in enumerate(jax.tree.leaves(eng.cache)):
    a = np.asarray(leaf)
    out[f"leaf{i}"] = a.view(np.uint8)
    out[f"dtype{i}"] = np.array(str(a.dtype))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''


def test_hybrid_cache_parity_matches_reference(tmp_path):
    path = tmp_path / "ref.npz"
    env = subprocess_env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    ref = dict(np.load(path))
    cfg = get_reduced(HYBRID)
    eng = ServeEngine(Model(cfg, device="cpu"), max_len=48, batch_size=4,
                      device="cpu")
    tree = eng.cache_tree()
    tdtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for i, leaf in enumerate(leaves(tree)):
        dt = tdtype[str(ref[f"dtype{i}"])]
        assert leaf.dtype == dt, (i, leaf.dtype, dt)
        raw = torch.from_numpy(ref[f"leaf{i}"].copy())
        leaf.copy_(raw.view(dt).reshape(leaf.shape))
    mesh = make_mesh((4, 1), ("data", "model"))
    eng.protect_cache(mesh, sharding.cache_specs(cfg, tree, mesh),
                      ecstore.ECConfig(k=2, m=1, page_size=256))
    np.testing.assert_array_equal(
        eng.ec_store.local_pages(eng.cache_tree()).numpy(), ref["pages"])
    np.testing.assert_array_equal(eng.ec_parity.numpy(), ref["parity"])
    for fail in (0, 3):
        np.testing.assert_array_equal(eng.recover_cache_pages(fail).numpy(),
                                      ref[f"recover{fail}"])
