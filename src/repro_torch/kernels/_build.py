"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` compiles each source into an object file, all sources
at once in parallel processes, and links them into one shared library
with a plain C interface, loaded with ``ctypes`` (a few seconds; a build
that includes PyTorch's headers takes minutes).  The build runs at first
use into ``build/repro_torch_kernels/`` at the root of the checkout, from
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

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gf256.cu", "flash_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "gf_error_string": ((_I,), ctypes.c_char_p),
    "gf_max_coefs": ((), _I),
    "gf_cols_max_coefs": ((), _I),
    "gf01_max_cols": ((), _I),
    "gf_matmul_batched": ((_I, _P, _I, _I, _P, _P, _I, _L, _P), _I),
    "gf_matmul_cols_batched": ((_I, _P, _I, _I, _P, _P, _I, _L, _P), _I),
    "gf01_matmul_batched": ((_I, _P, _I, _I, _L, _P, _P, _I, _L, _P), _I),
    "gf_coef_tier": ((_I,), _I),
    "gf_per_item": ((_I, _P, _I, _P, _P, _I, _I, _I, _L, _P), _I),
    "gf_per_item_fold": ((_I, _P, _I, _P, _P, _P, _I, _I, _I, _L, _P), _I),
    "gf_delta_apply_batched": ((_I, _P, _P, _P, _P, _I, _I, _L, _P), _I),
    "gf_delta_only_batched": ((_I, _P, _P, _P, _I, _I, _L, _P), _I),
    "gf_matmul": ((_I, _P, _I, _I, _P, _P, _L, _P), _I),
    "gf_delta_max_rows": ((), _I),
    "gf_delta_update": ((_P, _I, _P, _P, _P, _P, _L, _P), _I),
    "gf_cuckoo_probe": ((_P, _P, _P, _P, _P, _P, _P, _I, _P), _I),
    "flash_attention": ((_P, _P, _P, _P) + (_I,) * 6 + (_L,) * 9
                        + (ctypes.c_float,) + (_I,) * 5 + (_P,), _I),
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

    Processes that arrive at once (the ranks of ``distributed/ranks.py``,
    each importing the package anew) take an exclusive ``flock`` on the
    build directory's lock file, which the kernel drops when its holder
    exits, so one of them compiles and the others load its library; the
    build itself compiles and links in a temporary directory and renames
    the library into place atomically."""
    lib = BUILD_DIR / f"libkernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(lib)
    return lib


def _compile(lib: Path) -> None:
    """nvcc each source in parallel, link, and rename into ``lib``."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, f"{Path(s).stem}.o")
                for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        outs = [(s, p.communicate()[0], p.returncode)
                for s, p in zip(SOURCES, procs)]
        failed = [f"{s} ({rc}):\n{out}" for s, out, rc in outs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)


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


_NO_SWITCH = contextlib.nullcontext()


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device, for a
    launch on it.  When it already is (the common case) the context does
    nothing, which saves the device switch's few µs on every launch."""
    if device.index == torch.cuda.current_device():
        return _NO_SWITCH
    return torch.cuda.device(device)


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle.  A
    tensor's device carries its index; the raw getter skips building a
    ``torch.cuda.Stream`` object on every launch."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
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
