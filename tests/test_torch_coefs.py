"""Host pieces of the by-value kernels (1, 2 and 4-8), on the CPU.

* The in-register product of ``csrc/gf256.cu`` (``nib_tables``,
  ``nib_lookup``, ``gf_mul4``), emulated step for step in numpy with
  ``__byte_perm`` as the CUDA documentation defines it, against the
  JAX package's MUL_TABLE for all 65,536 (g, x) pairs.
* ``coefs.row_masks`` / ``per_item_coefs`` against the byte matrices
  and the reference's ``is01`` rule.
* ``coefs.plan_launches``: every item in one launch, in order, each
  launch within the parameter tier it names.
* Kernels 1, 2 and 8: the host-built nibble tables of a shared matrix
  (``coefs.nib_words``, ``matrix_tables``, ``matrix_tier``) against the
  emulated ``nib_tables`` and MUL_TABLE, their layout against the CUDA
  source, the kernels' body emulated on them against the JAX package's
  host product, and the wrappers' per-matrix plan.
* Kernel 3: the row masks the plan builds for a 0/1 matrix against a
  bit-pack of the matrix, their tiers at RDP's matrices, and the device
  route above the largest tier.  Kernel 9: the gamma bytes its wrapper
  packs.

The kernels themselves run only on a card (``test_torch_gpu.py``).
Tolerance: exact.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.gf256 import MUL_TABLE as REF_MUL_TABLE
from repro_torch.kernels import coefs

torch.set_num_threads(1)

U32 = np.uint32


def xtime(v):
    d = v << U32(1)
    return d ^ ((d >> U32(8)) * U32(0x11D))


def byte_perm(x, y, s):
    """CUDA ``__byte_perm``: byte n of the result is byte ((s >> 4n) & 7)
    of the eight bytes x | y << 32."""
    src = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, dtype=np.uint64)
    for n in range(4):
        idx = ((s >> U32(4 * n)) & U32(7)).astype(np.uint64)
        out |= ((src >> (np.uint64(8) * idx)) & np.uint64(0xFF)) \
            << np.uint64(8 * n)
    return out.astype(U32)


def selector(n):
    return byte_perm(n | (n >> U32(4)), U32(0), U32(0x0020))


def nib_select(w):
    """(lo, hi, lo8, hi8) of the kernel's ``Sel4``."""
    return (selector(w & U32(0x07070707)),
            selector((w >> U32(4)) & U32(0x07070707)),
            ((w >> U32(3)) & U32(0x01010101)) * U32(0xFF),
            ((w >> U32(7)) & U32(0x01010101)) * U32(0xFF))


def nib_tables(g):
    """(l0, l1, l8, h0, h1, h8) of the kernel's ``Nib``."""
    p = [g]
    for _ in range(7):
        p.append(xtime(p[-1]))
    rep = U32(0x01010101)
    l0 = (p[0] << U32(8)) | (p[1] << U32(16)) | ((p[0] ^ p[1]) << U32(24))
    h0 = (p[4] << U32(8)) | (p[5] << U32(16)) | ((p[4] ^ p[5]) << U32(24))
    return (l0, l0 ^ (p[2] * rep), p[3] * rep,
            h0, h0 ^ (p[6] * rep), p[7] * rep)


def gf_mul4(s, t):
    lo, hi, lo8, hi8 = s
    l0, l1, l8, h0, h1, h8 = t
    return byte_perm(l0, l1, lo) ^ (lo8 & l8) ^ byte_perm(h0, h1, hi) \
        ^ (hi8 & h8)


def test_register_product_matches_mul_table_for_every_pair():
    """g * x for all g and x: each g (one row) against 64 words that hold
    x = 4w .. 4w + 3, so every x sits in every byte position once over
    the grid's byte order."""
    g = np.arange(256, dtype=U32)[:, None]                      # (256, 1)
    xs = np.arange(256, dtype=np.uint8).reshape(64, 4)
    words = xs.view("<u4").reshape(1, 64).astype(U32)           # (1, 64)
    t = nib_tables(g)
    got = gf_mul4(nib_select(words), t).astype("<u4")           # (256, 64)
    got = got.view(np.uint8).reshape(256, 256)
    np.testing.assert_array_equal(got, REF_MUL_TABLE)
    # the same words rotated by a byte put every x in another position
    rot = np.roll(xs, 1, axis=1)
    got = gf_mul4(nib_select(rot.view("<u4").reshape(1, 64).astype(U32)), t)
    got = got.astype("<u4").view(np.uint8).reshape(256, 64, 4)
    np.testing.assert_array_equal(got, REF_MUL_TABLE[:, rot])


def test_nibble_tables_are_the_products_of_each_nibble():
    g = np.arange(256, dtype=U32)[:, None]
    l0, l1, l8, h0, h1, h8 = nib_tables(g)

    def entries(*words):
        return np.stack(words, axis=-1).astype("<u4").view(
            np.uint8).reshape(256, 4 * len(words))
    i = np.arange(8)
    np.testing.assert_array_equal(entries(l0, l1), REF_MUL_TABLE[:, i])
    np.testing.assert_array_equal(entries(h0, h1), REF_MUL_TABLE[:, 16 * i])
    np.testing.assert_array_equal(entries(l8), REF_MUL_TABLE[:, [8] * 4])
    np.testing.assert_array_equal(entries(h8), REF_MUL_TABLE[:, [128] * 4])


def test_selectors_hold_each_byte_in_order():
    """Selector nibble b is the low three bits of byte b's nibble; the
    masks are 0xFF where bit 3 of that nibble is set."""
    w = np.random.default_rng(3).integers(0, 2**32, 4096,
                                          dtype=np.uint64).astype(U32)
    lo, hi, lo8, hi8 = nib_select(w)
    b = np.stack([(w >> U32(8 * k)) & U32(0xFF) for k in range(4)], -1)
    for k in range(4):
        assert ((lo >> U32(4 * k)) & U32(7) == b[:, k] & U32(7)).all()
        assert ((hi >> U32(4 * k)) & U32(7)
                == (b[:, k] >> U32(4)) & U32(7)).all()
        assert (((lo8 >> U32(8 * k)) & U32(0xFF)) == np.where(
            b[:, k] & U32(8), U32(0xFF), U32(0))).all()
        assert (((hi8 >> U32(8 * k)) & U32(0xFF)) == np.where(
            b[:, k] & U32(128), U32(0xFF), U32(0))).all()


@pytest.mark.parametrize("J", [1, 7, 8, 9, 16, 31, 32])
def test_row_masks_hold_the_matrix(J):
    rng = np.random.default_rng(J)
    Ms = rng.integers(0, 2, (5, 3, J), dtype=np.uint8)
    masks = coefs.row_masks(Ms)
    assert masks.dtype == np.uint8 and masks.shape == (5, 3, -(-J // 8))
    assert coefs.mask_bytes(J) == masks.shape[-1]
    j = np.arange(J)
    bits = (masks[..., j // 8] >> (j % 8)) & 1
    np.testing.assert_array_equal(bits, Ms)
    # bits past J are clear, so the kernel's set-bit walk stays in range
    words = np.zeros((5, 3), dtype=np.uint64)
    for k in range(masks.shape[-1]):
        words |= masks[..., k].astype(np.uint64) << np.uint64(8 * k)
    assert (words >> np.uint64(J) == 0).all()


@pytest.mark.parametrize("case", ["zeros", "zero_one", "a_two", "general",
                                  "wide_zero_one", "empty"])
def test_per_item_form_follows_the_reference_is01_rule(case):
    rng = np.random.default_rng(len(case))
    shape = (4, 16, 40 if case == "wide_zero_one" else 16)
    if case in ("zeros", "empty"):
        Ms = np.zeros((0,) + shape[1:] if case == "empty" else shape,
                      np.uint8)
    elif case == "general":
        Ms = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        Ms = rng.integers(0, 2, shape, dtype=np.uint8)
        if case == "a_two":
            Ms[2, 5, 3] = 2
    # the reference's rule (repro/kernels/gf256_matmul.py, per-item entry)
    ref_is01 = int(Ms.max(initial=0)) <= 1
    assert coefs.is01(Ms) == ref_is01
    mb, host = coefs.per_item_coefs(Ms)
    if ref_is01 and Ms.shape[-1] <= coefs.MAX_MASK_COLS:
        assert mb == 2
        np.testing.assert_array_equal(host, coefs.row_masks(Ms))
    else:
        assert mb == 0
        np.testing.assert_array_equal(host, Ms)
    if not ref_is01:
        with pytest.raises(ValueError):
            coefs.row_masks(Ms)


@pytest.mark.parametrize("B,per_item", [
    (1, 1), (64, 2), (64, 32), (64, 64), (4096, 2), (4096, 1), (4096, 32),
    (4096, 64), (20000, 2), (40000, 1), (3, 32640), (5, 10000), (0, 4),
    (7, 0)])
def test_plan_covers_every_item_once_in_tier(B, per_item):
    plan = coefs.plan_launches(B, per_item)
    step = coefs.TIERS[-1] // per_item if per_item else max(B, 1)
    covered = []
    for n, (s, e, tier) in enumerate(plan):
        assert 0 <= s < e <= B
        need = (e - s) * per_item
        assert need <= coefs.TIERS[tier]
        # the smallest tier that holds the launch
        assert tier == 0 or need > coefs.TIERS[tier - 1]
        # whole items, as many as the largest tier takes but the last
        assert e - s == step or n == len(plan) - 1
        covered.extend(range(s, e))
    assert covered == list(range(B))


def test_plan_refuses_an_item_larger_than_the_parameters():
    with pytest.raises(ValueError):
        coefs.plan_launches(2, coefs.TIERS[-1] + 1)


def test_main_path_shapes_fit_one_launch():
    """At a YCSB window of 64 every main-path shape is one launch: the
    sealed-update gammas (64, 2), the RS seal (64, 1, 1), the RDP seal
    (64, 16, 16) as masks and the RDP delta (64, 32, 16) as masks."""
    seal, delta = (coefs.row_masks(np.ones((1, O, 16), np.uint8))[0].size
                   for O in (16, 32))
    assert (seal, delta) == (32, 64)
    for per_item in (2, 1, seal, delta):
        assert len(coefs.plan_launches(64, per_item)) == 1


def test_tiers_are_the_kernel_source_tiers():
    """The planner's tiers are the parameter-struct sizes the CUDA source
    instantiates (``gf_coef_tier`` returns them on the card)."""
    src = (Path(coefs.__file__).parent / "csrc" / "gf256.cu").read_text()
    m = re.search(r"kCoefTiers\[3\] = \{([^}]*)\}", src)
    assert m and tuple(int(v) for v in m.group(1).split(",")) == coefs.TIERS
    assert list(coefs.TIERS) == sorted(coefs.TIERS)


# ---------------------------------------------------------------------------
# kernels 1, 2 and 8: the shared matrix's nibble tables, built on the host
# ---------------------------------------------------------------------------

def _matrix(m, k, seed):
    """A general (m, k) matrix with 0 and 1 coefficients among the rest."""
    A = np.random.default_rng(seed).integers(2, 256, (m, k), dtype=np.uint8)
    A.reshape(-1)[::5] = 0
    A.reshape(-1)[1::7] = 1
    return A


def test_host_tables_give_the_mul_table_for_every_coefficient():
    """``coefs.nib_words`` are the kernels' ``nib_tables`` word for word,
    and through the emulated ``gf_mul4`` they give MUL_TABLE[g] for every
    g and all 256 bytes."""
    words = coefs.nib_words(np.arange(256))
    assert words.shape == (256, 6) and words.dtype == np.uint32
    for got, want in zip(np.moveaxis(words, -1, 0),
                         nib_tables(np.arange(256, dtype=U32))):
        np.testing.assert_array_equal(got, want)
    t = tuple(words[:, j:j + 1] for j in range(6))
    xs = np.arange(256, dtype=np.uint8).reshape(64, 4)
    got = gf_mul4(nib_select(xs.view("<u4").reshape(1, 64).astype(U32)), t)
    np.testing.assert_array_equal(
        got.astype("<u4").view(np.uint8).reshape(256, 256), REF_MUL_TABLE)


@pytest.mark.parametrize("m,k,tier", [(2, 8, 0), (10, 8, 1), (14, 10, 1),
                                      (40, 30, 2), (64, 64, coefs.DEVICE)])
def test_matrix_tables_layout_and_tier(m, k, tier):
    """Six little-endian words a coefficient, row-major, in the smallest
    tier that holds them; (64, 64)'s 96 KB exceed every tier and go to a
    device buffer."""
    A = _matrix(m, k, m * k)
    tabs = coefs.matrix_tables(A)
    assert tabs.dtype == np.dtype("<u4") and tabs.shape == (m * k * 6,)
    assert tabs.nbytes == 24 * m * k
    np.testing.assert_array_equal(tabs.reshape(m, k, 6), coefs.nib_words(A))
    r, i = m - 1, k // 2
    np.testing.assert_array_equal(tabs[6 * (r * k + i):6 * (r * k + i) + 6],
                                  coefs.nib_words(A[r, i]))
    assert coefs.matrix_tier(tabs.nbytes) == tier
    if tier == coefs.DEVICE:
        assert tabs.nbytes > coefs.TIERS[-1]
    else:
        assert tabs.nbytes <= coefs.TIERS[tier]
        assert tier == 0 or tabs.nbytes > coefs.TIERS[tier - 1]


def test_nib_layout_is_the_kernel_source():
    """``NIB_WORDS`` is the field order of ``struct Nib``; ``kNibOne`` is
    l0 of g = 1 (and g = 0's words are all 0, the skip); the largest tier
    holds 1,360 coefficients."""
    src = (Path(coefs.__file__).parent / "csrc" / "gf256.cu").read_text()
    m = re.search(r"struct Nib \{\s*uint32_t (\w+), (\w+), (\w+);"
                  r"\s*uint32_t (\w+), (\w+), (\w+);", src)
    assert m and m.groups() == coefs.NIB_WORDS
    one = re.search(r"kNibOne = (0x[0-9a-fA-F]+)u;", src)
    assert int(one.group(1), 16) == coefs.nib_words(1)[0]
    assert not coefs.nib_words(0).any()
    assert (coefs.nib_words(np.arange(2, 256))[:, 0]
            != coefs.nib_words(1)[0]).all()
    assert int(re.search(r"kNibWords = (\d+);", src).group(1)) \
        == len(coefs.NIB_WORDS)
    assert int(re.search(r"kDeviceTier = (-?\d+);", src).group(1)) \
        == coefs.DEVICE
    assert coefs.TIERS[-1] // (4 * len(coefs.NIB_WORDS)) == 1360


def _emulated_shared_matmul(A, D, rows):
    """The body of kernels 1 and 2 in numpy: per group of ``rows`` output
    rows, each input word's selectors once, then per row the coefficient's
    host-built words: l0 = 0 skips, l0 = kNibOne XORs, else gf_mul4."""
    m, k = A.shape
    B, _, C = D.shape
    tabs = coefs.matrix_tables(A).astype(U32).reshape(m, k, 6)
    one = coefs.nib_words(1)[0]
    words = np.ascontiguousarray(D).view("<u4").astype(U32)   # (B, k, C/4)
    out = np.zeros((B, m, C // 4), dtype=U32)
    for r0 in range(0, m, rows):
        for i in range(k):
            sel = nib_select(words[:, i])
            for r in range(r0, min(m, r0 + rows)):
                t = tabs[r, i]
                if t[0] == 0:
                    continue
                out[:, r] ^= words[:, i] if t[0] == one \
                    else gf_mul4(sel, tuple(t))
    return out.astype("<u4").view(np.uint8)


@pytest.mark.parametrize("m,k,rows", [(1, 1, 2), (2, 8, 2), (10, 8, 10),
                                      (10, 8, 2), (8, 16, 10), (14, 10, 7),
                                      (13, 10, 7), (40, 30, 7)])
def test_emulated_shared_matmul_matches_the_reference(m, k, rows):
    """The kernels' arithmetic on host-built tables against the JAX
    package's host GF(2^8) product, item by item."""
    from repro.core.gf256 import gf_matmul_np
    A = _matrix(m, k, 7 * m + k)
    D = np.random.default_rng(k).integers(0, 256, (3, k, 64), dtype=np.uint8)
    got = _emulated_shared_matmul(A, D, rows)
    for b in range(3):
        np.testing.assert_array_equal(got[b], gf_matmul_np(A, D[b]))


@pytest.mark.parametrize("shape,strategy,want", [
    ((10, 8), None, "unroll"), ((2, 8), None, "unroll"),
    ((14, 10), None, "cols"), ((64, 64), None, "cols"),
    ((28, 32), "unroll", "unroll"), ((10, 8), "gf01", "cols"),
    ((32, 128), None, "gf01"), ((300, 1000), None, "gf01")])
def test_card_plan_is_built_once_per_matrix(shape, strategy, want):
    """The wrappers' per-matrix plan: ``choose_strategy``'s body, the
    kernel's words as bytes (the nibble tables, or for ``gf01`` the row
    masks) with their tier (none above the largest tier: the card's copy
    is built alone, and holds the same words) and the matrix's nonzero
    count; a second call with the same matrix returns the cached plan."""
    import importlib
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    A = (np.random.default_rng(1).integers(0, 2, shape, dtype=np.uint8)
         if want == "gf01" else _matrix(*shape, sum(shape)))
    plan = gm._plan(A.tobytes(), A.shape, strategy)
    assert plan[0] == gm.choose_strategy(A, strategy) == want
    words = (coefs.matrix_masks(A) if want == "gf01"
             else coefs.matrix_tables(A))
    assert plan[2] == coefs.matrix_tier(words.nbytes)
    assert plan[1] == (None if plan[2] == coefs.DEVICE else words.tobytes())
    assert plan[3] == np.count_nonzero(A)
    if plan[2] == coefs.DEVICE:
        dev = gm._device_matrix(want, A.tobytes(), A.shape,
                                torch.device("cpu"))
        assert dev.numpy().tobytes() == words.tobytes()
    assert gm._plan(A.copy().tobytes(), A.shape, strategy) is plan


# ---------------------------------------------------------------------------
# kernel 3: the row masks of a shared 0/1 matrix; kernel 9: its gammas
# ---------------------------------------------------------------------------

def _bit_words(A):
    """Row masks by arithmetic: word w of row o is the sum of
    A[o, j] << (j - 32 w) over the columns j of that word."""
    M, K = A.shape
    words = np.zeros((M, -(-K // 32)), dtype=np.uint64)
    for j in range(K):
        words[:, j // 32] += A[:, j].astype(np.uint64) << np.uint64(j % 32)
    return words.astype("<u4")


@pytest.mark.parametrize("M,K", [(32, 128), (40, 33), (200, 1)])
def test_gf01_plan_holds_the_row_masks(M, K):
    """The masks ``_plan`` builds for a ``gf01`` matrix (K = 128, a ragged
    last word at K = 33, one column) are the matrix's bits, and no bit
    past K is set."""
    import importlib
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    A = (np.random.default_rng(M + K).random((M, K)) < 0.3).astype(np.uint8)
    A[0, K - 1] = 1
    strategy, words, tier, nnz = gm._plan(A.tobytes(), A.shape, None)
    assert strategy == "gf01" and nnz == A.sum()
    got = np.frombuffer(words, dtype="<u4").reshape(M, -1)
    np.testing.assert_array_equal(got, _bit_words(A))
    if K % 32:
        assert (got[:, -1] >> np.uint32(K % 32) == 0).all()


def _rdp_matrix(avail, wanted):
    """RDP(10,8)'s encode matrix (``wanted`` None), or the fused decode
    matrix the engine builds for one erasure pattern."""
    from repro_torch.core.codes import make_code
    from repro_torch.core.engine import NumpyEngine
    eng = NumpyEngine(make_code("rdp", 10, 8))
    if wanted is None:
        return eng.rep.encode
    return eng._fused_decode_matrix(
        eng.plan_decode([avail], [wanted], 4096).groups[0])


@pytest.mark.parametrize("avail,wanted,shape,tier,nnz", [
    (None, None, (32, 128), 0, 369),
    ([p for p in range(10) if p != 8], (8,), (144, 128), 1, 256),
    (range(2, 10), (0, 1, 8, 9), (160, 128), 1, 1744)])
def test_gf01_rdp_matrices_take_a_parameter_tier(avail, wanted, shape, tier,
                                                 nnz):
    """RDP's encode masks fit the 512-byte tier, its fused decodes' the
    4,096-byte one: no main-path matrix goes to the card.  The set bits
    (``nnz``, which picks kernel 3's body) are the ones ``csrc/gf256.cu``
    states."""
    import importlib
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    A = _rdp_matrix(avail, wanted)
    assert A.shape == shape
    plan = gm._plan(A.tobytes(), A.shape, None)
    assert plan[0] == "gf01" and plan[2] == tier and plan[3] == nnz
    assert len(plan[1]) == shape[0] * 4 * 4


@pytest.mark.parametrize("form", ["int32", "int64", "list", "uint8",
                                  "tensor_int32", "tensor_int64"])
def test_gamma_bytes_are_the_low_bytes(form):
    """The gammas kernel 9's wrapper (and kernel 6's) hands the kernel:
    ``g & 255`` as uint8, from host arrays, lists and tensors, negative
    and above 255 included."""
    g = np.array([0, 1, 2, 255, 256, 300, -1, 1000, 77], dtype=np.int64)
    want = (g & 255).astype(np.uint8)
    if form == "uint8":
        g = want
    arg = {"int32": lambda: g.astype(np.int32),
           "int64": lambda: g, "list": lambda: g.tolist(),
           "uint8": lambda: g,
           "tensor_int32": lambda: torch.from_numpy(g.astype(np.int32)),
           "tensor_int64": lambda: torch.from_numpy(g)}[form]()
    got = coefs.gamma_bytes(arg)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
