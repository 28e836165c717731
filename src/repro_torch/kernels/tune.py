"""Shape autotuner for the GF(2^8) data plane: the counterpart of the JAX
package's ``kernels/tune.py``.

The wrappers have real strategy choices, and the right one depends on
``(k, m, chunk, batch)`` and the dispatch path:

* on the card (``cuda-kernel``), the kernel body of a shared-matrix
  product (``unroll``, ``cols`` or ``gf01``, each within the kernels'
  matrix limits) and the coefficient form of a per-item product
  (``gf01``: 0/1 row masks, J <= 32; ``cols``: bytes);
* on the CPU (``torch-cpu``), the formulation of ``cpu_gf256``
  (``bitplane32``, ``select32``, ``table``).

The card has no tile knob: every entry carries ``block_c: 0``, as the
reference's XLA entries do.

* ``lookup(op, path, ...)``: the tuned entry of a shape, or None (callers
  then use their built-in rule: ``gf256_matmul.choose_strategy``,
  ``coefs.per_item_coefs``, ``cpu_gf256.default_strategy``), so a
  missing or corrupt cache never breaks dispatch.  ``active(op, path)``
  says whether the cache holds any entry for the pair, so a wrapper on a
  path without entries builds no key.
* ``autotune_matmul`` / ``autotune_delta_per_item``: time every valid
  candidate for one shape and record the winner (a candidate that raises
  is data).
* ``autotune_ci_shapes``: the reference's sweep, run by ``python -m
  repro_torch.kernels.tune [--device cpu] [--out PATH]``.

Cache file: ``$MEMEC_TORCH_TUNE_CACHE`` when set, else the committed
defaults ``kernels/tune_defaults.json`` (``torch-cpu`` entries only; the
file's ``host`` says which CPU measured them).  The JSON is ``{"version":
1, "entries": {key: entry}}`` with keys like
``matmul/cuda-kernel/gf/k8m2c4096b16``.  The cache loads and changes
under a lock: the sharded cluster's worker threads call the wrappers.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import threading
import time
import warnings

import numpy as np

DEFAULTS_PATH = os.path.join(os.path.dirname(__file__), "tune_defaults.json")
ENV = "MEMEC_TORCH_TUNE_CACHE"

_lock = threading.RLock()
_cache: dict | None = None
_cache_src: str | None = None          # path the cache was loaded from
_active: frozenset = frozenset()       # (op, path) pairs with entries
_warned: set = set()

#: ``os.environ``'s own map of encoded names to encoded values, and
#: ``ENV``'s key in it.  ``active`` runs on every wrapper call: a lookup
#: here costs ~0.08 µs where ``os.environ.get`` encodes and decodes
#: (~1.7 µs).  CPython updates this map on every ``os.environ`` write.
_ENV_DATA = getattr(os.environ, "_data", None)
_ENV_KEY = (os.environ.encodekey(ENV) if _ENV_DATA is not None else None)
_probed = object()      # the raw env value ``active`` last loaded for


def cache_path() -> str:
    """Active cache file: ``$MEMEC_TORCH_TUNE_CACHE`` or the defaults."""
    return os.environ.get(ENV) or DEFAULTS_PATH


def _warn_once(msg: str) -> None:
    if msg not in _warned:
        _warned.add(msg)
        warnings.warn(msg, stacklevel=3)


def _pairs(entries: dict) -> frozenset:
    return frozenset(tuple(k.split("/", 2)[:2]) for k in entries)


def load_cache(reload: bool = False) -> dict:
    """The tuning map (loaded lazily, again when the env path moves).  A
    missing or corrupt cache degrades to ``{}`` with one warning; entries
    that are not objects with a ``strategy`` are dropped."""
    global _cache, _cache_src, _active
    path = cache_path()
    cache = _cache
    if cache is not None and _cache_src == path and not reload:
        return cache
    with _lock:
        if _cache is not None and _cache_src == path and not reload:
            return _cache
        entries: dict = {}
        try:
            with open(path) as f:
                raw = json.load(f)
            body = raw.get("entries", raw) if isinstance(raw, dict) else None
            if isinstance(body, dict):
                entries = {k: v for k, v in body.items()
                           if isinstance(v, dict) and "strategy" in v}
            else:
                _warn_once(f"tune cache {path}: not a JSON object; ignoring")
        except FileNotFoundError:
            if path != DEFAULTS_PATH:
                _warn_once(f"tune cache {path}: not found; using heuristics")
        except (json.JSONDecodeError, OSError) as e:
            _warn_once(f"tune cache {path}: unreadable ({e}); using "
                       f"heuristics")
        _cache, _cache_src, _active = entries, path, _pairs(entries)
        return entries


def key(op: str, path: str, *, k: int, m: int, chunk: int, batch: int,
        cls: str = "gf") -> str:
    """Cache key: op, dispatch path, matrix class (``01`` matrices have
    strategies dense ones cannot use) and the shape."""
    return f"{op}/{path}/{cls}/k{k}m{m}c{chunk}b{batch}"


def matrix_cls(A) -> str:
    return "01" if int(np.asarray(A).max(initial=0)) <= 1 else "gf"


def active(op: str, path: str) -> bool:
    """Whether the cache holds any entry for ``op`` on ``path``: the
    wrappers' probe, one dict lookup and one set test while the env var
    holds the value it held at the last probe; a new value goes through
    ``load_cache``, as does every probe where ``os.environ`` keeps no
    such map."""
    global _probed
    if _ENV_DATA is None:
        load_cache()
    else:
        raw = _ENV_DATA.get(_ENV_KEY)
        if raw is not _probed:
            load_cache()
            _probed = raw
    return (op, path) in _active


def lookup(op: str, path: str, *, k: int, m: int, chunk: int, batch: int,
           cls: str = "gf") -> dict | None:
    """Tuned entry for a shape, or None (the caller's rule applies)."""
    return load_cache().get(key(op, path, k=k, m=m, chunk=chunk,
                                batch=batch, cls=cls))


def record(entry_key: str, entry: dict) -> None:
    global _active
    with _lock:
        load_cache()[entry_key] = entry
        _active = _pairs(_cache)


def save(path: str | None = None) -> str:
    """Write the in-memory cache (sorted, versioned, with the host that
    measured it) and return the path."""
    path = path or cache_path()
    with _lock:
        cache = dict(load_cache())
    with open(path, "w") as f:
        json.dump({"version": 1, "host": _host(),
                   "entries": {k: cache[k] for k in sorted(cache)}},
                  f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def _host() -> str:
    name = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), name)
    except OSError:
        pass
    return f"{name}, {os.cpu_count()} CPUs"


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _time_call(fn, device, reps: int = 5, calls: int = 10) -> float:
    """Median over ``reps`` of the µs per call of ``calls`` back-to-back
    calls.  The first call warms up (it absorbs the card's first kernel
    build).  On the card the calls are timed with CUDA events after a
    synchronize; on the CPU with ``perf_counter``."""
    import torch
    fn()
    cuda = torch.device(device).type == "cuda"
    times = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(calls):
                fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) * 1e3 / calls)
        else:
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t) * 1e6 / calls)
    return float(np.median(times))


def candidates(op: str, path: str, *, m: int, k: int,
               is01: bool) -> list[dict]:
    """Valid strategies for one op on one path, for an (m, k) matrix
    (a per-item product's (O, J) matrices)."""
    from . import coefs, cpu_gf256, dispatch
    if path == dispatch.TORCH_CPU:
        strategies = [cpu_gf256.BITPLANE32, cpu_gf256.TABLE]
        if is01:
            strategies.append(cpu_gf256.SELECT32)
    elif op == "delta_per_item":
        strategies = ["cols"]
        if is01 and k <= coefs.MAX_MASK_COLS:
            strategies.append("gf01")
    else:
        from .gf256_matmul import _limits
        lim = _limits()
        strategies = [s for s, n in (("unroll", m * k), ("cols", m * k))
                      if n <= lim[s]]
        if is01 and k <= lim["gf01"]:
            strategies.append("gf01")
    return [{"strategy": s, "block_c": 0} for s in strategies]


def _data(device, *shape):
    import torch
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.integers(0, 256, shape, dtype=np.uint8)).to(device)


def _best(label: str, cands: list, make_fn, device, reps: int,
          verbose: bool) -> tuple[dict, dict]:
    """(the fastest candidate's entry, every candidate's µs by strategy)."""
    best, timings = None, {}
    for cand in cands:
        fn = make_fn(cand["strategy"])
        try:
            us = _time_call(fn, device, reps=reps)
        except Exception as e:      # a candidate that cannot run is data
            if verbose:
                print(f"  {cand} failed: {type(e).__name__}: {e}")
            continue
        if verbose:
            print(f"  {label} {cand} -> {us:.2f}us")
        timings[cand["strategy"]] = us
        if best is None or us < best["us"]:
            best = dict(cand, us=round(us, 2))
    if best is None:
        raise RuntimeError(f"{label}: no tuning candidate ran")
    return best, timings


def autotune_matmul(A: np.ndarray, *, chunk: int, batch: int, device=None,
                    reps: int = 5, verbose: bool = False) -> dict:
    """Tune the shared-matrix product for one (A, chunk, batch) on
    ``device`` (None: the card).  A batch-1 entry steers the
    single-stripe ``gf256_matmul``, so that call is timed.  Records the
    winning entry and returns it with ``timings``, every candidate's µs."""
    from . import dispatch
    from .gf256_matmul import gf256_matmul, gf256_matmul_batched
    device = dispatch.resolve_device(device)
    path = dispatch.decide(device).path
    A = np.ascontiguousarray(A, dtype=np.uint8)
    O, J = A.shape
    data = _data(device, max(batch, 1), J, chunk)
    is01 = matrix_cls(A) == "01"

    def make_fn(s):
        if batch == 1:
            return lambda: gf256_matmul(A, data[0], strategy=s)
        return lambda: gf256_matmul_batched(A, data, strategy=s)
    label = f"matmul k{J}m{O}c{chunk}b{batch}"
    best, timings = _best(label, candidates("matmul", path, m=O, k=J,
                                            is01=is01),
                          make_fn, device, reps, verbose)
    record(key("matmul", path, k=J, m=O, chunk=chunk, batch=batch,
               cls="01" if is01 else "gf"), best)
    return dict(best, timings=timings)


def autotune_delta_per_item(M: np.ndarray, *, chunk: int, batch: int,
                            device=None, reps: int = 5,
                            verbose: bool = False) -> dict:
    """Tune the per-item-matrix delta fold (the r > 1 RDP update shape
    and the hot-tier flush collapse).  ``M`` is one (O, J) per-item
    prototype, replicated across the batch; ``chunk`` is the device-side
    block width.  Records the winning entry and returns it with
    ``timings``, every candidate's µs."""
    from . import dispatch
    from .delta_update import delta_apply_per_item_batched
    device = dispatch.resolve_device(device)
    path = dispatch.decide(device).path
    M = np.ascontiguousarray(M, dtype=np.uint8)
    O, J = M.shape
    B = max(batch, 1)
    Ms = np.ascontiguousarray(np.broadcast_to(M, (B, O, J)))
    blocks = _data(device, B, J, chunk)
    parity = _data(device, B, O, chunk)
    is01 = matrix_cls(M) == "01"

    def make_fn(s):
        return lambda: delta_apply_per_item_batched(parity, Ms, blocks,
                                                    strategy=s)
    label = f"delta_per_item k{J}m{O}c{chunk}b{batch}"
    best, timings = _best(label, candidates("delta_per_item", path, m=O,
                                            k=J, is01=is01),
                          make_fn, device, reps, verbose)
    record(key("delta_per_item", path, k=J, m=O, chunk=chunk, batch=batch,
               cls="01" if is01 else "gf"), best)
    return dict(best, timings=timings)


def ci_shapes() -> tuple[list, list]:
    """The reference's CI shapes: ``(matmul, delta_per_item)`` lists of
    (matrix, chunk, batch)."""
    from ..core.codes import RSCode, make_code
    from ..core.engine import block_rep
    rs = RSCode(n=10, k=8)
    rdp = make_code("rdp", 10, 8)
    rep = block_rep(rdp)
    P = np.asarray(rs.parity_matrix)
    matmul = [(P, 4096, 1),                   # encode row
              (P, 4096, 16),                  # batched engine row
              (P, 65536, 1),                  # slow-sweep encode row
              (np.asarray(rep.encode), 4096 // rep.r, 4)]   # RDP (0/1)
    # the RDP per-item system is the (m*r, r) column slice of the block
    # matrix (0/1) at width chunk / r; the RS hot-tier collapse the (m, 1)
    # parity-matrix column at full width (dense)
    E4 = np.asarray(rep.encode).reshape(rdp.m * rep.r, rdp.k, rep.r)
    Mi = np.ascontiguousarray(E4[:, 0, :])
    per_item = [(Mi, 4096 // rep.r, 4), (Mi, 4096 // rep.r, 16),
                (np.ascontiguousarray(P[:, :1]), 512, 4)]
    return matmul, per_item


def autotune_ci_shapes(verbose: bool = True, device=None) -> list[dict]:
    """Tune ``ci_shapes`` on ``device`` (None: the card); returns each
    shape's winner with its candidates' ``timings``, matmul shapes
    first."""
    matmul, per_item = ci_shapes()
    return ([autotune_matmul(A, chunk=chunk, batch=batch, device=device,
                             verbose=verbose) for A, chunk, batch in matmul]
            + [autotune_delta_per_item(M, chunk=chunk, batch=batch,
                                       device=device, verbose=verbose)
               for M, chunk, batch in per_item])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--out", default=None,
                    help="cache file to write (default: the active one)")
    args = ap.parse_args(argv)
    if args.out:
        os.environ[ENV] = args.out
        load_cache(reload=True)
    autotune_ci_shapes(device=args.device)
    print(f"wrote {save(args.out)}")


if __name__ == "__main__":
    main()
