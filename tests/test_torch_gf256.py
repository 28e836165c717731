"""The port's GF(2^8) field and codes against the JAX package's.

Tables, inverses and the bit-plane lift must be the same bytes; the
torch device ops must agree with the reference's jnp ops; RS, XOR and RDP
encode/decode must agree with ``repro.core.codes``.  The framework-free
modules the port copies must stay byte-identical to their originals, and
importing the port must not pull in JAX or the reference package.
Tolerance: exact equality everywhere.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import subprocess_env
from repro.core import codes as ref_codes
from repro.core import gf256 as ref_gf
from repro_torch.core import codes, gf256

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_tables_equal_reference():
    assert gf256.POLY == ref_gf.POLY
    np.testing.assert_array_equal(gf256.EXP_TABLE, ref_gf.EXP_TABLE)
    np.testing.assert_array_equal(gf256.LOG_TABLE, ref_gf.LOG_TABLE)
    np.testing.assert_array_equal(gf256.MUL_TABLE, ref_gf.MUL_TABLE)


@pytest.mark.parametrize("n", [1, 4, 8, 10, 16])
def test_mat_inv_equals_reference(n):
    rng = np.random.default_rng(n)
    for _ in range(5):
        M = rng.integers(0, 256, (n, n), dtype=np.uint8)
        try:
            want = ref_gf.gf_mat_inv(M)
        except np.linalg.LinAlgError:
            with pytest.raises(np.linalg.LinAlgError):
                gf256.gf_mat_inv(M)
            continue
        got = gf256.gf_mat_inv(M)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gf256.gf_matmul_np(M, got),
                                      np.eye(n, dtype=np.uint8))


def test_scalar_ops_and_lift_equal_reference():
    rng = np.random.default_rng(1)
    for a in range(1, 256):
        assert gf256.gf_inv_np(a) == ref_gf.gf_inv_np(a)
        b = int(rng.integers(0, 256))
        assert gf256.gf_div_np(b, a) == ref_gf.gf_div_np(b, a)
    A = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    np.testing.assert_array_equal(gf256.lift_matrix(A), ref_gf.lift_matrix(A))
    np.testing.assert_array_equal(gf256.gf_mul_np(A, A[::-1]),
                                  ref_gf.gf_mul_np(A, A[::-1]))


def test_torch_device_ops_equal_reference_jnp_ops():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (40, 33), dtype=np.uint8)
    b = rng.integers(0, 256, (40, 33), dtype=np.uint8)
    a[0, :5] = 0
    b[1, :5] = 0
    np.testing.assert_array_equal(
        gf256.gf_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_gf.gf_mul(a, b)))
    np.testing.assert_array_equal(
        gf256.gf_scale(29, torch.from_numpy(a)).numpy(),
        np.asarray(ref_gf.gf_scale(29, a)))
    A = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    D = rng.integers(0, 256, (10, 3, 77), dtype=np.uint8)
    np.testing.assert_array_equal(
        gf256.gf_matmul(torch.from_numpy(A), torch.from_numpy(D)).numpy(),
        np.asarray(ref_gf.gf_matmul(A, D)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int16, np.uint8])
def test_bytes_view_round_trip_equals_reference(dtype):
    x = (np.arange(60, dtype=np.float64) * 1.5 - 7).astype(dtype).reshape(5, 12)
    got = gf256.bytes_view(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_gf.bytes_view(x)))
    back = gf256.from_bytes_view(got, torch.from_numpy(x).dtype, x.shape)
    np.testing.assert_array_equal(back.numpy(), x)


CODES = [("rs", 10, 8), ("rs", 6, 4), ("rs", 14, 10), ("xor", 5, 4),
         ("rdp", 6, 4), ("rdp", 10, 8)]


@pytest.mark.parametrize("scheme,n,k", CODES)
def test_codes_equal_reference(scheme, n, k):
    port, ref = codes.make_code(scheme, n, k), ref_codes.make_code(scheme, n, k)
    assert (port.n, port.k, port.m) == (ref.n, ref.k, ref.m)
    rng = np.random.default_rng(n * 100 + k)
    C = 1000 if scheme != "rdp" else 16 * (ref.p - 1)
    data = rng.integers(0, 256, (k, C), dtype=np.uint8)
    par = port.encode(data)
    np.testing.assert_array_equal(par, ref.encode(data))
    stripe = np.concatenate([data, par])
    # single and double erasures (up to the code's tolerance), data and
    # parity wanted
    erasure_sets = [(0,), (k - 1,), (k,), (n - 1,)]
    if port.m >= 2:
        erasure_sets += [(0, 1), (1, k), (k, n - 1)]
    for lost in erasure_sets:
        avail = {p: stripe[p] for p in range(n) if p not in lost}
        got = port.decode(dict(avail), list(lost), C)
        want = ref.decode(dict(avail), list(lost), C)
        for p in lost:
            np.testing.assert_array_equal(got[p], want[p])
            np.testing.assert_array_equal(got[p], stripe[p])
    x = rng.integers(0, 256, C, dtype=np.uint8)
    for i in range(k):
        np.testing.assert_array_equal(port.xor_delta(i, x),
                                      ref.xor_delta(i, x))


COPIED = ["core/codes.py", "core/chunk.py", "core/index.py", "core/stripe.py",
          "core/coordinator.py", "core/proxy.py", "core/server.py",
          "core/hotkey.py", "core/trace.py", "core/netsim.py", "core/store.py",
          "core/ring.py", "core/rebalance.py", "core/shard.py",
          "core/telemetry.py", "core/baselines.py", "core/analysis.py",
          "data/ycsb.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_are_verbatim(rel):
    """The framework-free modules are copies: their relative imports
    resolve to the port's gf256 and engine, and they must not drift."""
    assert (SRC / "repro_torch" / rel).read_bytes() == \
        (SRC / "repro" / rel).read_bytes()


def test_import_hygiene_no_jax_no_reference():
    code = ("import sys\n"
            "import repro_torch.core, repro_torch.kernels\n"
            "import repro_torch.configs.memec, repro_torch.data.ycsb\n"
            "import repro_torch.kernels.ops, repro_torch.quickstart\n"
            "import repro_torch.core.shard, repro_torch.kernels.cuckoo_lookup\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=subprocess_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stdout + out.stderr


def test_port_sources_name_no_jax_or_reference_import():
    pattern = ("import jax", "from jax", "import repro\n", "import repro.",
               "from repro.", "from repro ")
    roots = [SRC / "repro_torch", SRC.parent / "chip_smoke.py"]
    files = [p for r in roots for p in
             ([r] if r.is_file() else sorted(r.rglob("*.py")))]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        for pat in pattern:
            assert pat not in text, f"{path}: {pat!r}"
    assert os.path.exists(SRC / "repro_torch" / "kernels" / "csrc" / "gf256.cu")
