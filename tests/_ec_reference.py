"""The reference's EC-store outputs for the port's twin tests, shared by
``test_torch_ecstore.py`` (the stacked store) and ``test_torch_ranks.py``
(one position per rank).

The reference runs one device per mesh position inside ``shard_map``, so
its outputs come from one subprocess with 12 forced host devices (as
``tests/test_distributed.py`` runs it), written to an ``.npz``: the EC
operations on random pages (from numpy seeds) over the two meshes of the
reference's tests, the state store on reduced starcoder2-3b parameters
(``PRNGKey(0)``, and the same perturbed), the collectives over a
12-position axis, and the serving cache protected over (4, 1).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from conftest import subprocess_env
from repro.configs import get_reduced as ref_get_reduced
from repro.models import Model as RefModel
from repro_torch.configs import get_reduced
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax

ARCH = "starcoder2-3b"

#: (name, mesh shape, k, m, page): the two meshes of the reference's tests
MESHES = [("rs10_8", (12, 1), 8, 2, 64), ("rs3_2", (4, 2), 2, 1, 256)]
PAIRS = [(3, 7), (2, 3), (0, 11)]
RECONSTRUCT_AT = {"rs10_8": (0, 3, 11), "rs3_2": (0, 1, 3)}

_REFERENCE = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_reduced
from repro.distributed import collectives as C
from repro.distributed import ecstore as E
from repro.distributed import sharding as shd
from repro.distributed._compat import shard_map
from repro.models import Model
from repro.serve.engine import ServeEngine

MESHES = %(meshes)r
PAIRS = %(pairs)r
RECONSTRUCT_AT = %(reconstruct_at)r
out = {}

def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))

def run(mesh, f, ins, outs, *args):
    g = shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs,
                  check_rep=False)
    with mesh:
        return np.asarray(jax.jit(g)(*args))

sspec = P("data", "model", None, None)
pspec = P("data", "model", None, None, None)
strip = lambda x: x.reshape(x.shape[2:])
lift = lambda x: x.reshape((1, 1) + x.shape)

cfg_m = get_reduced("starcoder2-3b")
model = Model(cfg_m)
params = model.init(jax.random.PRNGKey(0))
new_params = jax.tree.map(lambda x: (x.astype(jnp.float32) * 1.01 + 1e-3)
                          .astype(x.dtype), params)
for name, shape, k, m, page in MESHES:
    mesh = mesh_of(shape)
    cfg = E.ECConfig(k=k, m=m, page_size=page)
    A = shape[0]
    rng = np.random.default_rng(A)
    state = rng.integers(0, 256, shape + (4 * k, page), dtype=np.uint8)
    xor = rng.integers(0, 256, state.shape, dtype=np.uint8)
    par = run(mesh, lambda pg: lift(E.encode_parity(strip(pg), cfg)),
              (sspec,), pspec, jnp.asarray(state))
    out[f"{name}/state"], out[f"{name}/xor"] = state, xor
    out[f"{name}/encode"] = par
    for fn in ("parity_delta_update", "parity_delta_update_chain"):
        f = getattr(E, fn)
        out[f"{name}/{fn}"] = run(
            mesh, lambda x, p: lift(f(strip(x), strip(p), cfg)),
            (sspec, pspec), pspec, jnp.asarray(xor), jnp.asarray(par))
    for fail in RECONSTRUCT_AT[name]:
        holed = state.copy(); holed[fail] = 0
        out[f"{name}/holed{fail}"] = holed
        out[f"{name}/reconstruct{fail}"] = run(
            mesh, lambda pg, p: lift(E.reconstruct_failed(
                strip(pg), strip(p), jnp.int32(fail), cfg)),
            (sspec, pspec), sspec, jnp.asarray(holed), jnp.asarray(par))
    if m >= 2:
        for f1, f2 in PAIRS:
            holed = state.copy(); holed[f1] = 0; holed[f2] = 0
            parz = par.copy(); parz[f1] = 0; parz[f2] = 0
            out[f"{name}/pair_in{f1}_{f2}"] = holed
            out[f"{name}/pair_par{f1}_{f2}"] = parz
            out[f"{name}/pair{f1}_{f2}"] = run(
                mesh, lambda pg, p: lift(E.reconstruct_failed_pair(
                    strip(pg), strip(p), f1, f2, A, cfg)),
                (sspec, pspec), sspec, jnp.asarray(holed), jnp.asarray(parz))
    # the state store on reduced starcoder2-3b parameters
    specs = shd.param_specs(cfg_m, jax.eval_shape(lambda: params), mesh)
    store = E.ECStateStore(mesh, specs, cfg)
    with mesh:
        out[f"{name}/bytes_of_tree"] = np.asarray(store._wrap(
            lambda st: E.bytes_of_tree(st).reshape(1, 1, -1), (specs,),
            P("data", "model", None))(params))
        out[f"{name}/local_pages"] = np.asarray(store.local_pages(params))
        enc = store.encode(params)
        out[f"{name}/store_encode"] = np.asarray(enc)
        upd = store.delta_update(params, new_params, enc)
        out[f"{name}/store_delta"] = np.asarray(upd)
        for fail in RECONSTRUCT_AT[name]:
            out[f"{name}/store_reconstruct{fail}"] = np.asarray(
                store.reconstruct(new_params, upd, fail))
# collectives over a 12-position axis
mesh = mesh_of((12, 1))
rng = np.random.default_rng(5)
x = rng.integers(0, 256, (12, 1, 3, 40), dtype=np.uint8)
f = rng.standard_normal((12, 1, 5, 70)).astype(np.float32)
xs, fs = P("data", "model", None, None), P("data", "model", None, None)
out["coll/x"], out["coll/f"] = x, f
for shift in (1, 5):
    out[f"coll/ring_shift{shift}"] = run(
        mesh, lambda v: C.ring_shift(v, "data", shift), (xs,), xs,
        jnp.asarray(x))
out["coll/ring_xor_reduce"] = run(
    mesh, lambda v: C.ring_xor_reduce(v, "data"), (xs,), xs, jnp.asarray(x))
out["coll/compressed_psum"] = run(
    mesh, lambda v: C.compressed_psum(v, "data", block=64), (fs,), fs,
    jnp.asarray(f))
# the serving cache: RS(3,2) over a (4, 1) mesh
mesh = mesh_of((4, 1))
eng = ServeEngine(model, params, max_len=16, batch_size=4)
toks = np.random.default_rng(7).integers(0, cfg_m.vocab_size, (4, 12))
eng.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
cspecs = shd.cache_specs(cfg_m, jax.eval_shape(lambda: eng.cache), mesh)
eng.protect_cache(mesh, cspecs, E.ECConfig(k=2, m=1, page_size=256))
with mesh:
    out["cache/pages"] = np.asarray(eng.ec_store.local_pages(eng.cache))
    out["cache/parity"] = np.asarray(eng.ec_parity)
    for fail in (0, 2):
        out[f"cache/recover{fail}"] = np.asarray(eng.recover_cache_pages(fail))
for i, leaf in enumerate(jax.tree.leaves(eng.cache)):
    out[f"cache/leaf{i}"] = np.asarray(leaf).view(np.uint16)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
'''




def reference_arrays(path) -> dict:
    """Run the reference in a subprocess with 12 host devices, write its
    outputs to ``path`` (an ``.npz``) and return them."""
    code = _REFERENCE % dict(meshes=MESHES, pairs=PAIRS,
                             reconstruct_at=RECONSTRUCT_AT)
    env = subprocess_env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=12"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


def reference_param_models() -> tuple:
    """(config, [old, new]): the reference's reduced starcoder2-3b
    parameters (``PRNGKey(0)``) in two of the port's models, before and
    after the perturbation the subprocess applies."""
    cfg = get_reduced(ARCH)
    tree = RefModel(ref_get_reduced(ARCH)).init(jax.random.PRNGKey(0))
    new = jax.tree.map(lambda x: (x.astype(jnp.float32) * 1.01 + 1e-3)
                       .astype(x.dtype), tree)
    models = []
    for t in (tree, new):
        m = Model(cfg, device="cpu")
        params_from_jax(m, jax.tree.map(np.asarray, t))
        models.append(m)
    return cfg, models
