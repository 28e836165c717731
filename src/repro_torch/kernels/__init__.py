"""Hand-written CUDA kernels for MemEC's coding data plane, with plain
torch versions beside them.

* gf256_matmul — one matrix times a batch of stripes (encode, decode; the
  unroll, 0/1 and column-loop kernels), and per-item matrices with or
  without a parity fold (seal fold, hot-key collapse, RDP deltas);
* delta_update — batched P' = P ⊕ gamma·(D ⊕ D') parity maintenance.

``dispatch`` sends CUDA tensors to the kernels and CPU tensors to the
plain versions; ``_build`` compiles ``csrc/*.cu`` with nvcc at first use
and binds it with ctypes; ``ref`` holds the torch oracles.
"""
from . import dispatch, ref
from .delta_update import delta_apply_batched, delta_apply_per_item_batched
from .gf256_matmul import gf256_matmul_batched, gf256_matmul_per_item_batched


def launch_counts() -> dict[str, int]:
    """Launches of every kernel by its wrapper, by kernel name."""
    from . import delta_update, gf256_matmul
    return {**gf256_matmul.LAUNCHES, **delta_update.LAUNCHES}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    from . import delta_update, gf256_matmul
    for counts in (gf256_matmul.LAUNCHES, delta_update.LAUNCHES):
        for name in counts:
            counts[name] = 0


__all__ = ["dispatch", "ref", "delta_apply_batched",
           "delta_apply_per_item_batched", "gf256_matmul_batched",
           "gf256_matmul_per_item_batched", "launch_counts",
           "reset_launch_counts"]
