"""The EC store and the collectives with one mesh position per rank
(``distributed/ranks.py``) against the JAX package's per-device bodies
and against the port's stacked store.

One spawn per mesh (a module fixture): gloo ranks on the CPU, initialised
through a ``file://`` store in the fixture's temporary directory (no
port, so parallel test workers never race for one), joined with a 120 s
deadline.  Every operation runs inside that one spawn
(``_rank_worker.mesh_body``) and each rank writes its outputs to an
``.npz``.  The reference's outputs come from ``_ec_reference`` (one
subprocess with 12 host devices), the inputs from the same numpy seeds
as ``test_torch_ecstore.py``.

Meshes and codes: RS(10,8) with 64-byte pages over (12, 1) and RS(3,2)
with 256-byte pages over (4, 2), the reference tests' two; and RS(3,2)
over (4, 1), the layout of ``chip_smoke.py``'s training copy, for
``ECCheckpoint`` alone (the reference has no outputs there).  Each rank
is held at its coordinate to the reference's global arrays and to the
stacked store's: exact bytes, except ``compressed_psum`` (1e-6 of the
largest |sum|, as in ``test_torch_ecstore.py``).  The bytes a rank sends
equal m*k*S pages an update and (A - 1)*k*S a rebuild, and the dry run's
count of the same body (``ranks.CountingComm``).  The (4, 1) spawn also
protects the reference's serving cache on a ``RankModel`` in each rank
(``ServeEngine.protect_cache`` over the rank's data column), held to the
reference's pages, parity and rebuilds byte for byte.
"""
import numpy as np
import pytest
import torch

import _rank_worker
from _ec_reference import (MESHES, PAIRS, RECONSTRUCT_AT, reference_arrays,
                           reference_param_models)
from repro_torch.distributed import collectives, ecstore, ranks, sharding
from repro_torch.distributed.collectives import recording
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import param_tree
from repro_torch.train.checkpoint import ECCheckpoint
from repro_torch.tree import Stacked, tree_map

torch.set_num_threads(1)

#: the reference tests' meshes, and RS(3,2) over (4, 1) for the checkpoint
RANK_MESHES = MESHES + [("rs3_2_4x1", (4, 1), 2, 1, 256)]
REBUILD_AT = dict(RECONSTRUCT_AT, rs3_2_4x1=(0, 1, 3))
NAMES = [x[0] for x in RANK_MESHES]
#: the mesh whose spawn also protects the reference's serving cache: the
#: reference's (4, 1) and RS(3,2) with 256-byte pages
CACHE_MESH = "rs3_2_4x1"
DEADLINE = 120.0


def _spec(name):
    return next(x for x in RANK_MESHES if x[0] == name)


def _detached(tree):
    return tree_map(lambda x: Stacked(p.detach() for p in x.parts)
                    if isinstance(x, Stacked) else x.detach(), tree)


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    """The reference's outputs' ``.npz``, which the ranks read."""
    path = tmp_path_factory.mktemp("ranks_ref") / "ref.npz"
    reference_arrays(path)
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    with np.load(ref_path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def models():
    return reference_param_models()


@pytest.fixture(scope="module")
def spawned(ref_path, models, tmp_path_factory):
    """{mesh name: (per-rank results, per-rank outputs)}: one spawn per
    mesh, every operation inside it."""
    cfg_model, (old_model, new_model) = models
    old = _detached(param_tree(old_model))
    new = _detached(param_tree(new_model))
    out = {}
    for name, shape, k, m, page in RANK_MESHES:
        d = tmp_path_factory.mktemp(f"ranks_{name}")
        mesh = make_mesh(shape, ("data", "model"))
        specs = sharding.param_specs(cfg_model, old, mesh)
        args = [(str(ref_path), str(d / f"rank{r}.npz"), name, k, m, page,
                 PAIRS, REBUILD_AT[name], (old, new), specs,
                 cfg_model if name == CACHE_MESH else None)
                for r in range(mesh.size)]
        res = ranks.launch(_rank_worker.mesh_body, mesh, args,
                           init_file=str(d / "init"), timeout=DEADLINE)
        outs = []
        for r in range(mesh.size):
            with np.load(d / f"rank{r}.npz") as f:
                outs.append(dict(f))
        out[name] = (res, outs)
    return out


def _cfg(name):
    _, shape, k, m, page = _spec(name)
    return make_mesh(shape, ("data", "model")), ecstore.ECConfig(
        k=k, m=m, page_size=page)


def _t(a):
    return torch.from_numpy(np.array(a))


def _each_rank(spawned, name, key, want_global, stacked_global=None):
    """Every rank's ``key`` equals ``want_global`` (and the stacked
    store's ``stacked_global``) at its coordinate."""
    mesh, _ = _cfg(name)
    _, outs = spawned[name]
    for r, got in enumerate(outs):
        at = mesh.coords(r)
        np.testing.assert_array_equal(got[key], want_global[at],
                                      err_msg=f"{name} rank {r} {key}")
        if stacked_global is not None:
            np.testing.assert_array_equal(
                got[key], np.asarray(stacked_global[at]),
                err_msg=f"{name} rank {r} {key} (stacked)")


# ---------------------------------------------------------------------------
# the EC operations on random pages
# ---------------------------------------------------------------------------

REF_NAMES = [x[0] for x in MESHES]


@pytest.mark.parametrize("name", REF_NAMES)
def test_rank_encode_matches_reference_and_stacked(ref, spawned, name):
    _, cfg = _cfg(name)
    stacked = ecstore.encode_parity(_t(ref[f"{name}/state"]), cfg)
    _each_rank(spawned, name, "encode", ref[f"{name}/encode"], stacked)


@pytest.mark.parametrize("fn", ["parity_delta_update",
                                "parity_delta_update_chain"])
@pytest.mark.parametrize("name", REF_NAMES)
def test_rank_delta_update_matches_reference_and_stacked(ref, spawned, name,
                                                         fn):
    _, cfg = _cfg(name)
    stacked = getattr(ecstore, fn)(_t(ref[f"{name}/xor"]),
                                   _t(ref[f"{name}/encode"]), cfg)
    key = "update" if fn == "parity_delta_update" else "update_chain"
    _each_rank(spawned, name, key, ref[f"{name}/{fn}"], stacked)


@pytest.mark.parametrize("name,fail", [(n, f) for n in RECONSTRUCT_AT
                                       for f in RECONSTRUCT_AT[n]])
def test_rank_reconstruct_matches_reference_and_stacked(ref, spawned, name,
                                                        fail):
    _, cfg = _cfg(name)
    stacked = ecstore.reconstruct_failed(_t(ref[f"{name}/holed{fail}"]),
                                         _t(ref[f"{name}/encode"]), fail, cfg)
    _each_rank(spawned, name, f"reconstruct{fail}",
               ref[f"{name}/reconstruct{fail}"], stacked)
    mesh, _ = _cfg(name)
    for r, got in enumerate(spawned[name][1]):
        np.testing.assert_array_equal(
            got[f"reconstruct{fail}"],
            ref[f"{name}/state"][fail, mesh.coords(r)[1]])


@pytest.mark.parametrize("f1,f2", PAIRS)
def test_rank_reconstruct_pair_matches_reference_and_stacked(ref, spawned,
                                                             f1, f2):
    mesh, cfg = _cfg("rs10_8")
    key = f"pair{f1}_{f2}"
    stacked = ecstore.reconstruct_failed_pair(
        _t(ref[f"rs10_8/pair_in{f1}_{f2}"]),
        _t(ref[f"rs10_8/pair_par{f1}_{f2}"]), f1, f2, mesh.axis_sizes[0], cfg)
    _each_rank(spawned, "rs10_8", key, ref[f"rs10_8/{key}"], stacked)


@pytest.mark.parametrize("name", REF_NAMES)
def test_faulted_ring_differs(ref, spawned, name):
    """A control: the encode over a ring that shifts by -s must not equal
    the reference's."""
    mesh, _ = _cfg(name)
    outs = spawned[name][1]
    assert any(not np.array_equal(got["faulted_encode"],
                                  ref[f"{name}/encode"][mesh.coords(r)])
               for r, got in enumerate(outs))


# ---------------------------------------------------------------------------
# the collectives over 12 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [1, 5])
def test_rank_ring_shift_matches_reference(ref, spawned, shift):
    stacked = collectives.ring_shift(_t(ref["coll/x"]), shift, dim=0)
    _each_rank(spawned, "rs10_8", f"ring_shift{shift}",
               ref[f"coll/ring_shift{shift}"], stacked)


def test_rank_ring_xor_reduce_matches_reference(ref, spawned):
    stacked = collectives.ring_xor_reduce(_t(ref["coll/x"]), dim=0)
    _each_rank(spawned, "rs10_8", "ring_xor_reduce",
               ref["coll/ring_xor_reduce"], stacked)


def test_rank_compressed_psum_matches_reference(ref, spawned):
    want = ref["coll/compressed_psum"]
    stacked = collectives.compressed_psum(_t(ref["coll/f"]), dim=0, block=64)
    mesh, _ = _cfg("rs10_8")
    atol = 1e-6 * float(np.abs(want).max())
    for r, got in enumerate(spawned["rs10_8"][1]):
        at = mesh.coords(r)
        np.testing.assert_allclose(got["compressed_psum"], want[at], rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(got["compressed_psum"],
                                   stacked[at].numpy(), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# ECCheckpoint on reduced starcoder2-3b parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_rank_checkpoint_matches_reference_and_stacked(ref, models, spawned,
                                                       name):
    """Each rank's ``ECCheckpoint``: its pages, ``create``, ``update`` and
    ``stage``/in-place change/``commit`` equal the stacked checkpoint's
    (and the reference's store, on its meshes); ``commit`` equals
    ``update``; each rebuild equals the reference's and the live pages of
    the rebuilt position."""
    mesh, cfg = _cfg(name)
    cfg_model, (old_model, new_model) = models
    old, new = param_tree(old_model), param_tree(new_model)
    specs = sharding.param_specs(cfg_model, old, mesh)
    ec = ECCheckpoint(mesh, specs, cfg)
    pages = ec.store.local_pages(old)
    create = ec.create(old).clone()
    update = ec.store.delta_update(old, new, create)
    live = ec.store.local_pages(new)
    outs = spawned[name][1]
    has_ref = f"{name}/store_encode" in ref
    for r, got in enumerate(outs):
        at = mesh.coords(r)
        np.testing.assert_array_equal(got["ckpt/pages"], pages[at].numpy())
        np.testing.assert_array_equal(got["ckpt/create"], create[at].numpy())
        np.testing.assert_array_equal(got["ckpt/update"], update[at].numpy())
        np.testing.assert_array_equal(got["ckpt/commit"], got["ckpt/update"])
        np.testing.assert_array_equal(got["ckpt/live"], live[at].numpy())
        if has_ref:
            np.testing.assert_array_equal(got["ckpt/pages"],
                                          ref[f"{name}/local_pages"][at])
            np.testing.assert_array_equal(got["ckpt/create"],
                                          ref[f"{name}/store_encode"][at])
            np.testing.assert_array_equal(got["ckpt/commit"],
                                          ref[f"{name}/store_delta"][at])
        for f in REBUILD_AT[name]:
            rec = got[f"ckpt/reconstruct{f}"]
            np.testing.assert_array_equal(rec, live[f, at[1]].numpy())
            if has_ref:
                np.testing.assert_array_equal(
                    rec, ref[f"{name}/store_reconstruct{f}"][at])


def test_rank_protected_cache_matches_reference(ref, spawned):
    """``ServeEngine.protect_cache`` on each rank's ``RankModel`` over
    (4, 1), its cache block the reference's prefill cache's: the rank's
    pages, parity and the rebuilds of data positions 0 and 2 equal the
    reference's ``protect_cache`` (the (4, 1) mesh's stacked arrays) at
    the rank's coordinate, byte for byte."""
    _each_rank(spawned, CACHE_MESH, "cache/pages", ref["cache/pages"])
    _each_rank(spawned, CACHE_MESH, "cache/parity", ref["cache/parity"])
    for fail in (0, 2):
        _each_rank(spawned, CACHE_MESH, f"cache/recover{fail}",
                   ref[f"cache/recover{fail}"])


# ---------------------------------------------------------------------------
# bytes sent, launches, paths
# ---------------------------------------------------------------------------

def _blocks(name, op):
    """The reference's sends of one call of ``op``, in (S, page) blocks."""
    _, (A, _), k, m, _ = _spec(name)
    return {"encode": m * k, "update": m * k, "ckpt_create": m * k,
            "ckpt_commit": m * k,
            "update_chain": k * m + m * (m - 1) // 2,
            "reconstruct": (A - 1) * k, "ckpt_reconstruct": (A - 1) * k,
            "reconstruct_pair": (A - 1) * k}[op]


def _dry_count(name, op, P):
    """What the dry run's ``CountingComm`` counts for one call of ``op``
    on (P, page) pages at mesh position 0."""
    mesh, cfg = _cfg(name)
    comm = ranks.CountingComm(mesh, (0, 0))
    S = P // cfg.k
    pages = torch.empty((P, cfg.page_size), dtype=torch.uint8, device="meta")
    parity = torch.empty((cfg.m, S, cfg.page_size), dtype=torch.uint8,
                         device="meta")
    calls = {
        "encode": lambda: ecstore.rank_encode_parity(pages, cfg, comm),
        "update": lambda: ecstore.rank_parity_delta_update(pages, parity,
                                                           cfg, comm),
        "update_chain": lambda: ecstore.rank_parity_delta_update_chain(
            pages, parity, cfg, comm),
        "reconstruct": lambda: ecstore.rank_reconstruct_failed(
            pages, parity, 1, cfg, comm),
        "reconstruct_pair": lambda: ecstore.rank_reconstruct_failed_pair(
            pages, parity, 3, 7, cfg, comm)}
    calls["ckpt_create"] = calls["ckpt_commit"] = calls["update"]
    calls["ckpt_reconstruct"] = calls["reconstruct"]
    got = []
    with dispatch.dry_run(), recording(lambda n, kind: got.append(n)):
        calls[op]()
    return sum(got)


@pytest.mark.parametrize("name", NAMES)
def test_rank_bytes_sent_follow_the_reference(spawned, name):
    """Per rank and operation: m*k*S pages for an encode or update,
    k*m + m(m-1)/2 for the chain, (A - 1)*k*S for a rebuild - each call
    counted, and equal to the dry run's count of the same body."""
    _, cfg = _cfg(name)
    res, outs = spawned[name]
    calls = {"reconstruct": len(REBUILD_AT[name]),
             "ckpt_reconstruct": len(REBUILD_AT[name]),
             "reconstruct_pair": len(PAIRS)}
    for r, (info, got) in enumerate(zip(res, outs)):
        assert set(info["sent"]) >= {"ckpt_create", "ckpt_commit",
                                     "ckpt_reconstruct"}, info["sent"]
        for op, nbytes in info["sent"].items():
            P = (got["ckpt/pages"].shape[0] if op.startswith("ckpt")
                 else got["encode"].shape[1] * cfg.k)
            n = calls.get(op, 1)
            block = P // cfg.k * cfg.page_size
            assert nbytes == n * _blocks(name, op) * block, (r, op)
            assert nbytes == n * _dry_count(name, op, P), (r, op)


@pytest.mark.parametrize("name", NAMES)
def test_rank_products_took_the_cpu_path(spawned, name):
    """On CPU tensors every rank's products ran the plain path, and no
    kernel launched."""
    res, _ = spawned[name]
    for info in res:
        assert info["op_paths"] and set(info["op_paths"].values()) == {
            dispatch.TORCH_CPU}, info["op_paths"]
        assert not any(info["launches"].values()), info["launches"]


# ---------------------------------------------------------------------------
# the mesh's coordinates, local blocks, and the launcher's failures
# ---------------------------------------------------------------------------

def test_mesh_coords_are_row_major():
    mesh = make_mesh((2, 4, 3), ("pod", "data", "model"))
    assert [mesh.coords(r) for r in range(mesh.size)] == [
        (p, d, m) for p in range(2) for d in range(4) for m in range(3)]
    assert all(mesh.rank_of(mesh.coords(r)) == r for r in range(mesh.size))
    with pytest.raises(ValueError):
        mesh.coords(24)
    with pytest.raises(ValueError):
        mesh.rank_of((0, 4, 0))


def test_local_block_is_the_stacked_view_at_the_coordinate():
    mesh = make_mesh((4, 2), ("data", "model"))
    t = torch.arange(8 * 6).reshape(8, 6)
    spec = sharding.P("data", "model")
    whole = sharding.local_view(t, spec, mesh)
    parts = Stacked([t, t + 1])
    for r in range(mesh.size):
        at = mesh.coords(r)
        assert torch.equal(sharding.local_block(t, spec, mesh, at), whole[at])
        got = sharding.local_block(parts, sharding.P(None, "data", "model"),
                                   mesh, at)
        assert isinstance(got, Stacked) and torch.equal(got.parts[1],
                                                        whole[at] + 1)
    assert sharding.writes_block(spec, mesh, (3, 1))
    assert sharding.writes_block(sharding.P("data"), mesh, (3, 0))
    assert not sharding.writes_block(sharding.P("data"), mesh, (3, 1))
    assert not sharding.writes_block(sharding.P(), mesh, (1, 0))


def test_launch_fails_when_a_rank_fails(tmp_path):
    mesh = make_mesh((2, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        ranks.launch(_rank_worker.failing_body, mesh,
                     init_file=str(tmp_path / "init"), timeout=DEADLINE)


def test_launch_kills_the_ranks_at_its_deadline(tmp_path):
    mesh = make_mesh((2, 1), ("data", "model"))
    with pytest.raises(TimeoutError, match="did not return"):
        ranks.launch(_rank_worker.hanging_body, mesh,
                     init_file=str(tmp_path / "init"), timeout=20.0)
