"""The port's distributed layer against the JAX package's: the erasure-coded
state store, the collectives, the sharding rules, the elastic monitor and
the EC protection of the serving cache.

The reference runs one device per mesh position inside ``shard_map``, so
its outputs come from one subprocess with 12 forced host devices (as
``tests/test_distributed.py`` runs it), computed once for the module and
written to an ``.npz``.  The port holds every position in one tensor; its
global arrays must equal the reference's ``out_specs`` arrays.

Meshes and codes: RS(10,8) with 64-byte pages over a (12, 1) mesh and
RS(3,2) with 256-byte pages over (4, 2), first on random page arrays
(encode, delta update, the systolic chain variant, single and pair
reconstruction), then through ``ECStateStore`` on reduced starcoder2-3b
parameters carried over by ``params_from_jax`` (bytes of the tree, local
pages, encode, delta update, reconstruction at three positions).  The
serving cache: the reference's prefill cache, copied into the port's
engine, protected with RS(3,2) over (4, 1).  Tolerance: exact bytes,
except ``compressed_psum`` (fp32 sums in another order: 1e-6 relative to
the largest |sum|).
"""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ec_reference import (MESHES, PAIRS, RECONSTRUCT_AT, reference_arrays,
                           reference_param_models)
from repro.configs import ARCH_NAMES, get_reduced as ref_get_reduced
from repro.distributed import collectives as ref_coll
from repro.distributed import sharding as ref_shd
from repro.distributed._compat import abstract_mesh
from repro.models import Model as RefModel
from repro_torch.configs import get_reduced
from repro_torch.distributed import collectives, ecstore, sharding
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import Model
from repro_torch.models.convert import param_tree
from repro_torch.serve import ServeEngine
from repro_torch.tree import leaves

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "starcoder2-3b"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, from one subprocess with 12 host devices."""
    return reference_arrays(tmp_path_factory.mktemp("ecstore") / "ref.npz")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(name):
    _, shape, k, m, page = next(x for x in MESHES if x[0] == name)
    return shape, ecstore.ECConfig(k=k, m=m, page_size=page)


# ---------------------------------------------------------------------------
# the EC operations on random pages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [x[0] for x in MESHES])
def test_encode_matches_reference(ref, name):
    _, cfg = _cfg(name)
    got = ecstore.encode_parity(_t(ref[f"{name}/state"]), cfg)
    np.testing.assert_array_equal(got.numpy(), ref[f"{name}/encode"])


@pytest.mark.parametrize("fn", ["parity_delta_update",
                                "parity_delta_update_chain"])
@pytest.mark.parametrize("name", [x[0] for x in MESHES])
def test_delta_update_matches_reference(ref, name, fn):
    _, cfg = _cfg(name)
    par = _t(ref[f"{name}/encode"])
    got = getattr(ecstore, fn)(_t(ref[f"{name}/xor"]), par, cfg)
    np.testing.assert_array_equal(got.numpy(), ref[f"{name}/{fn}"])
    np.testing.assert_array_equal(par.numpy(), ref[f"{name}/encode"])


@pytest.mark.parametrize("name,fail", [(n, f) for n in RECONSTRUCT_AT
                                       for f in RECONSTRUCT_AT[n]])
def test_reconstruct_matches_reference(ref, name, fail):
    _, cfg = _cfg(name)
    got = ecstore.reconstruct_failed(_t(ref[f"{name}/holed{fail}"]),
                                     _t(ref[f"{name}/encode"]), fail, cfg)
    np.testing.assert_array_equal(got.numpy(),
                                  ref[f"{name}/reconstruct{fail}"])
    state = ref[f"{name}/state"]
    for d in range(state.shape[0]):
        np.testing.assert_array_equal(got[d].numpy(), state[fail])


@pytest.mark.parametrize("f1,f2", PAIRS)
def test_reconstruct_pair_matches_reference(ref, f1, f2):
    shape, cfg = _cfg("rs10_8")
    pages, par = ref[f"rs10_8/pair_in{f1}_{f2}"], ref[f"rs10_8/pair_par{f1}_{f2}"]
    got = ecstore.reconstruct_failed_pair(_t(pages), _t(par), f1, f2,
                                          shape[0], cfg)
    np.testing.assert_array_equal(got.numpy(), ref[f"rs10_8/pair{f1}_{f2}"])
    np.testing.assert_array_equal(got[0, 0].numpy(),
                                  ref["rs10_8/state"][f1, 0])


def test_reconstruct_pair_refuses_an_undecodable_pair():
    cfg = ecstore.ECConfig(k=2, m=1, page_size=16)
    pages = torch.zeros((4, 1, 4, 16), dtype=torch.uint8)
    par = ecstore.encode_parity(pages, cfg)
    with pytest.raises(ValueError, match="undecodable"):
        ecstore.reconstruct_failed_pair(pages, par, 0, 1, 4, cfg)


def test_single_position_mesh_reconstructs_its_own_pages():
    """On one position (k = m = 1) the reference's single-failure rebuild
    never picks parity row 0 (it looks for it at list position k, not k
    mod A) and returns zeros; the port wraps the position and rebuilds
    the pages."""
    cfg = ecstore.ECConfig(k=1, m=1, page_size=32)
    pages = _t(np.random.default_rng(1).integers(0, 256, (1, 1, 6, 32),
                                                 dtype=np.uint8))
    par = ecstore.encode_parity(pages, cfg)
    got = ecstore.reconstruct_failed(pages, par, 0, cfg)
    assert torch.equal(got, pages) and bool(pages.any())


# ---------------------------------------------------------------------------
# the state store on model parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def twin_params():
    """The reference's reduced parameters (PRNGKey(0)) in the port's model,
    before and after the subprocess's perturbation."""
    return reference_param_models()


def _store(name, cfg_model, params):
    shape, cfg = _cfg(name)
    mesh = make_mesh(shape, ("data", "model"))
    specs = sharding.param_specs(cfg_model, params, mesh)
    return ecstore.ECStateStore(mesh, specs, cfg), specs, mesh


@pytest.mark.parametrize("name", [x[0] for x in MESHES])
def test_store_bytes_and_pages_match_reference(ref, twin_params, name):
    cfg_model, (model, _) = twin_params
    params = param_tree(model)
    store, specs, mesh = _store(name, cfg_model, params)
    got = ecstore.bytes_of_tree(params, specs, mesh)
    np.testing.assert_array_equal(got.numpy(), ref[f"{name}/bytes_of_tree"])
    np.testing.assert_array_equal(store.local_pages(params).numpy(),
                                  ref[f"{name}/local_pages"])


@pytest.mark.parametrize("name", [x[0] for x in MESHES])
def test_store_encode_delta_reconstruct_match_reference(ref, twin_params,
                                                        name):
    cfg_model, (old_model, new_model) = twin_params
    old, new = param_tree(old_model), param_tree(new_model)
    store, _, _ = _store(name, cfg_model, old)
    enc = store.encode(old)
    np.testing.assert_array_equal(enc.numpy(), ref[f"{name}/store_encode"])
    upd = store.delta_update(old, new, enc)
    np.testing.assert_array_equal(upd.numpy(), ref[f"{name}/store_delta"])
    np.testing.assert_array_equal(upd.numpy(), store.encode(new).numpy())
    live = store.local_pages(new)
    for fail in RECONSTRUCT_AT[name]:
        rec = store.reconstruct(new, upd, fail)
        np.testing.assert_array_equal(
            rec.numpy(), ref[f"{name}/store_reconstruct{fail}"])
        assert torch.equal(rec[0], live[fail])


def test_to_pages_and_tree_xor_pages(twin_params):
    """The reference's page helpers: ``to_pages`` of the tree's bytes is
    ``local_pages``, and ``tree_xor_pages`` is the XOR of two states'
    pages."""
    cfg_model, (old_model, new_model) = twin_params
    old, new = param_tree(old_model), param_tree(new_model)
    store, specs, mesh = _store("rs3_2", cfg_model, old)
    pages = store.local_pages(old)
    assert torch.equal(ecstore.to_pages(
        ecstore.bytes_of_tree(old, specs, mesh), store.cfg), pages)
    xor = ecstore.tree_xor_pages(old, new, store.cfg, specs, mesh)
    assert torch.equal(xor, pages ^ store.local_pages(new))
    flat = ecstore.bytes_of_tree(old)
    assert flat.dim() == 1 and flat.numel() == sum(
        t.numel() * t.element_size() for t in old_model.parameters())


def test_ec_checkpoint_stage_commit_equals_update(twin_params):
    """The in-place path (stage the old bytes, update, commit) gives the
    functional update's parity."""
    from repro_torch.train.checkpoint import ECCheckpoint
    cfg_model, (old_model, new_model) = twin_params
    model = Model(cfg_model, device="cpu")
    model.load_state_dict(old_model.state_dict())
    params = param_tree(model)
    shape, cfg = _cfg("rs3_2")
    mesh = make_mesh(shape, ("data", "model"))
    ec = ECCheckpoint(mesh, sharding.param_specs(cfg_model, params, mesh),
                      cfg)
    ec.create(params)
    want = ec.store.delta_update(param_tree(old_model),
                                 param_tree(new_model), ec.parity)
    ec.stage(params)
    model.load_state_dict(new_model.state_dict())
    ec.commit(params)
    assert torch.equal(ec.parity, want)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def test_gf_scale_static_matches_reference():
    x = np.arange(256, dtype=np.uint8)
    for gamma in range(256):
        want = np.asarray(ref_coll.gf_scale_static(gamma, jnp.asarray(x)))
        got = collectives.gf_scale_static(gamma, torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", [1, 5])
def test_ring_shift_matches_reference(ref, shift):
    got = collectives.ring_shift(_t(ref["coll/x"]), shift, dim=0)
    np.testing.assert_array_equal(got.numpy(), ref[f"coll/ring_shift{shift}"])


def test_ring_xor_reduce_matches_reference(ref):
    got = collectives.ring_xor_reduce(_t(ref["coll/x"]), dim=0)
    np.testing.assert_array_equal(got.numpy(), ref["coll/ring_xor_reduce"])


def test_compressed_psum_matches_reference(ref):
    got = collectives.compressed_psum(_t(ref["coll/f"]), dim=0, block=64)
    want = ref["coll/compressed_psum"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

SPEC_MESHES = [((4, 2), ("data", "model")),
               ((2, 4, 2), ("pod", "data", "model"))]


def _shapes(tree):
    return jax.tree.map(lambda s: types.SimpleNamespace(shape=s.shape), tree)


def _spec_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("mesh_shape,axes", SPEC_MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_cache_specs_match_reference(arch, mesh_shape, axes):
    cfg = ref_get_reduced(arch)
    ref_mesh = abstract_mesh(mesh_shape, axes)
    mesh = make_mesh(mesh_shape, axes)
    model = RefModel(cfg)
    pshape = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cshape = jax.eval_shape(lambda: model.init_cache(8, 16))
    for fn, shape in (("param_specs", pshape), ("cache_specs", cshape)):
        want = _spec_leaves(getattr(ref_shd, fn)(cfg, shape, ref_mesh))
        got = [tuple(s) for s in leaves(getattr(sharding, fn)(
            get_reduced(arch), _shapes(shape), mesh))]
        assert got == want, (arch, fn)


@pytest.mark.parametrize("mesh_shape,axes", SPEC_MESHES)
def test_batch_specs_match_reference(mesh_shape, axes):
    shapes = {"tokens": (8, 16), "labels": (8, 16), "positions": (3, 8, 16),
              "odd": (3, 5), "scale": ()}
    cfg = ref_get_reduced(ARCH)
    want = _spec_leaves(ref_shd.batch_specs(
        cfg, {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in
              shapes.items()}, abstract_mesh(mesh_shape, axes)))
    got = sharding.batch_specs(
        get_reduced(ARCH), {k: types.SimpleNamespace(shape=v)
                            for k, v in shapes.items()},
        make_mesh(mesh_shape, axes))
    assert [tuple(x) for x in leaves(got)] == want


def test_fit_spec_demotes_indivisible():
    P = sharding.P
    mesh = make_mesh((4, 2), ("data", "model"))
    assert sharding.fit_spec(P("data", "model"), (8, 6), mesh) == \
        P("data", "model")
    assert sharding.fit_spec(P("data", "model"), (7, 6), mesh) == \
        P(None, "model")
    assert sharding.fit_spec(P(("pod", "data"), None), (4, 3), mesh) == \
        P(("data",), None)


def test_local_view_is_each_positions_block():
    mesh = make_mesh((2, 4, 2), ("pod", "data", "model"))
    t = torch.arange(8 * 6 * 3).reshape(8, 6, 3)
    v = sharding.local_view(t, sharding.P(("pod", "data"), "model"), mesh)
    assert v.shape == (2, 4, 2, 1, 3, 3)
    for p in range(2):
        for d in range(4):
            for m in range(2):
                assert torch.equal(v[p, d, m],
                                   t[p * 4 + d:p * 4 + d + 1,
                                     3 * m:3 * m + 3])


def test_production_meshes_are_descriptions():
    from repro_torch.launch.mesh import make_production_mesh
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    assert make_host_mesh().shape == {"data": 1, "model": 1}


# ---------------------------------------------------------------------------
# elastic monitor (a copy of the reference's) and the serving cache
# ---------------------------------------------------------------------------

def test_elastic_is_a_copy_but_for_its_import():
    port = (SRC / "repro_torch/distributed/elastic.py").read_text()
    ref_text = (SRC / "repro/distributed/elastic.py").read_text()
    assert port == ref_text.replace(
        "from repro.core.coordinator import ServerState",
        "from ..core.coordinator import ServerState")


def test_elastic_monitor_degrades_a_silent_host():
    from repro_torch.core.coordinator import ServerState
    from repro_torch.distributed.elastic import ElasticConfig, FleetMonitor
    mon = FleetMonitor(4, ElasticConfig(heartbeat_interval=1.0,
                                        miss_threshold=3))
    for t in range(8):
        for h in range(4):
            if h != 2 or t < 3:
                mon.heartbeat(h, float(t))
    plan = mon.check(8.0)
    assert (plan.kind, plan.failed_hosts) == ("reconstruct", [2])
    assert mon.states()[2] == ServerState.DEGRADED


def test_protected_cache_matches_reference(ref):
    """The reference's prefill cache, copied into the port's engine:
    local pages, parity and the recovered pages of two positions equal
    the reference's."""
    cfg = get_reduced(ARCH)
    model = Model(cfg, device="cpu")
    eng = ServeEngine(model, max_len=16, batch_size=4, device="cpu")
    tree = eng.cache_tree()
    for i, leaf in enumerate(leaves(tree)):
        bits = torch.from_numpy(ref[f"cache/leaf{i}"].view(np.int16))
        leaf.copy_(bits.view(torch.bfloat16))
    mesh = make_mesh((4, 1), ("data", "model"))
    specs = sharding.cache_specs(cfg, tree, mesh)
    eng.protect_cache(mesh, specs, ecstore.ECConfig(k=2, m=1, page_size=256))
    np.testing.assert_array_equal(
        eng.ec_store.local_pages(eng.cache_tree()).numpy(),
        ref["cache/pages"])
    np.testing.assert_array_equal(eng.ec_parity.numpy(), ref["cache/parity"])
    for fail in (0, 2):
        np.testing.assert_array_equal(
            eng.recover_cache_pages(fail).numpy(), ref[f"cache/recover{fail}"])


def test_refresh_cache_parity_follows_decode():
    cfg = get_reduced(ARCH)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    eng = ServeEngine(model, max_len=12, batch_size=2, device="cpu")
    logits = eng.prefill({"tokens": torch.randint(0, cfg.vocab_size, (2, 5))})
    mesh = make_mesh((4, 1), ("data", "model"))
    cfg_ec = ecstore.ECConfig(k=2, m=1, page_size=256)
    eng.protect_cache(mesh, sharding.cache_specs(cfg, eng.cache_tree(), mesh),
                      cfg_ec)
    old = eng.cache_snapshot()
    eng.decode(4, first_tokens=torch.argmax(logits, dim=-1))
    eng.refresh_cache_parity(old)
    assert torch.equal(eng.ec_parity, eng.ec_store.encode(eng.cache_tree()))
    live = eng.ec_store.local_pages(eng.cache_tree())
    for fail in range(4):
        assert torch.equal(eng.recover_cache_pages(fail)[0], live[fail])
