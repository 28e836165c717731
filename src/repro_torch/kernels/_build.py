"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` compiles the sources into a shared library with a plain
C interface, loaded with ``ctypes`` (a few seconds; a build that
includes PyTorch's headers takes minutes).  The build runs at first use
into ``build/repro_torch_kernels/`` at the root of the checkout, from
the sources in the checkout only, and is keyed by a hash of the sources
and flags so an edited kernel never loads a stale library.

Nothing here runs at import: this module is imported on hosts without
``nvcc`` or a card, where only the plain torch versions run.

The wrappers are entered from several threads at once (the sharded
cluster runs each shard's group of a multi-key request on its own
worker), so the first build, the device caches and the launch counts
each fill or change under a lock.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gf256.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "gf_error_string": ((_I,), ctypes.c_char_p),
    "gf_max_coefs": ((), _I),
    "gf_cols_max_coefs": ((), _I),
    "gf01_max_cols": ((), _I),
    "gf_matmul_batched": ((_P, _I, _I, _P, _P, _P, _I, _L, _P), _I),
    "gf_matmul_cols_batched": ((_P, _P, _I, _I, _P, _P, _I, _L, _P), _I),
    "gf01_matmul_batched": ((_P, _I, _I, _P, _P, _I, _L, _P), _I),
    "gf_per_item": ((_P, _P, _P, _P, _I, _I, _I, _L, _P), _I),
    "gf_per_item_fold": ((_P, _P, _P, _P, _P, _I, _I, _I, _L, _P), _I),
    "gf_delta_apply_batched": ((_P, _P, _P, _P, _P, _I, _I, _L, _P), _I),
    "gf_delta_only_batched": ((_P, _P, _P, _P, _I, _I, _L, _P), _I),
    "gf_matmul": ((_P, _I, _I, _P, _P, _P, _L, _P), _I),
    "gf_delta_max_rows": ((), _I),
    "gf_delta_update": ((_P, _P, _I, _P, _P, _P, _P, _L, _P), _I),
    "gf_cuckoo_probe": ((_P, _P, _P, _P, _P, _P, _P, _I, _P), _I),
}

_LOCK = threading.Lock()
_LIBRARY: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cand.append(which)
    for c in cand:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library.

    Concurrent builders are safe: each compiles into a temporary file and
    renames it into place atomically."""
    lib = BUILD_DIR / f"libgf256_{_digest()}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[str(CSRC / s) for s in SOURCES]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library with every signature declared; the
    first caller builds it while any other thread waits."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _LIBRARY = lib
        return _LIBRARY


def locked_cache(maxsize: int | None):
    """``functools.lru_cache`` whose fills run one at a time, so two
    threads never copy the same value to the card twice."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)
        lock = threading.Lock()

        @functools.wraps(fn)
        def call(*args):
            with lock:
                return cached(*args)
        return call
    return wrap


_COUNT_LOCK = threading.Lock()


def count_launch(launches: dict, name: str) -> None:
    """Add one launch of kernel ``name`` to a wrapper module's counts
    (``+=`` on a dict entry can lose counts across threads)."""
    with _COUNT_LOCK:
        launches[name] += 1


def read_counts(*launches: dict) -> dict[str, int]:
    """One consistent copy of several modules' launch counts."""
    with _COUNT_LOCK:
        return {k: v for d in launches for k, v in d.items()}


def reset_counts(*launches: dict) -> None:
    """Set every launch count in ``launches`` to 0."""
    with _COUNT_LOCK:
        for d in launches:
            for name in d:
                d[name] = 0


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().gf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


@locked_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    from ..core import gf256
    host = np.concatenate([gf256.MUL_TABLE.reshape(-1), gf256.EXP_TABLE,
                           gf256.LOG_TABLE.astype(np.uint8)])
    return torch.from_numpy(host).to(device)


def tables(device: torch.device) -> torch.Tensor:
    """The device table buffer the kernels read:
    MUL_TABLE (65536) | EXP_TABLE (512) | LOG_TABLE (256), uint8."""
    return _tables(torch.device(device))


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Validate a kernel operand before its pointer goes to C."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
