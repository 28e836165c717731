"""Hand-written CUDA kernels for MemEC's coding data plane and index
probe, with plain torch versions beside them.

* gf256_matmul — one matrix times one stripe or a batch of stripes
  (encode, decode; the unroll, 0/1 and column-loop kernels), and
  per-item matrices with or without a parity fold (seal fold, hot-key
  collapse, RDP deltas);
* delta_update — P' = P ⊕ gamma·(D ⊕ D') parity maintenance, batched
  and single-stripe (old and new bytes fused in);
* cuckoo_lookup — the batched 2-bucket x 4-slot object-index probe.

``ops`` holds the public single-stripe entry points; ``dispatch`` sends
CUDA tensors to the kernels and CPU tensors to the plain versions;
``_build`` compiles ``csrc/*.cu`` with nvcc at first use and binds it
with ctypes; ``ref`` holds the torch oracles.
"""
from . import _build, dispatch, ops, ref
from .cuckoo_lookup import LAUNCHES as _PROBE_LAUNCHES
from .cuckoo_lookup import cuckoo_lookup
from .delta_update import LAUNCHES as _DELTA_LAUNCHES
from .delta_update import (delta_apply_batched, delta_apply_per_item_batched,
                           delta_update)
from .gf256_matmul import LAUNCHES as _MATMUL_LAUNCHES
from .gf256_matmul import (gf256_matmul, gf256_matmul_batched,
                           gf256_matmul_per_item_batched)

# the package names ``gf256_matmul``/``delta_update``/``cuckoo_lookup``
# are the entry points, as in the JAX package; reach the modules through
# ``importlib.import_module("repro_torch.kernels.<name>")``
_LAUNCH_TABLES = (_MATMUL_LAUNCHES, _DELTA_LAUNCHES, _PROBE_LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel by its wrapper, by kernel name."""
    return _build.read_counts(*_LAUNCH_TABLES)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _build.reset_counts(*_LAUNCH_TABLES)


__all__ = ["dispatch", "ops", "ref", "cuckoo_lookup", "delta_apply_batched",
           "delta_apply_per_item_batched", "delta_update", "gf256_matmul",
           "gf256_matmul_batched", "gf256_matmul_per_item_batched",
           "launch_counts", "reset_launch_counts"]
