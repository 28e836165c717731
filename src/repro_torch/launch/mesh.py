"""Meshes as values: named axis sizes.

The reference builds ``jax.sharding.Mesh`` objects over real devices
(``src/repro/launch/mesh.py``).  Here a mesh is only its axis names and
sizes, and the port holds its positions in one of two ways:

* stacked on one card: state laid out over the mesh carries the mesh's
  axes as leading tensor dimensions, in the mesh's axis order
  (``distributed/ecstore.py``: pages ``(A_data, A_model, P, page)``);
* one position per rank of a ``torch.distributed`` process group
  (``distributed/ranks.py``): rank r holds position ``coords(r)``,
  row-major in the axis order, the order in which the stacked arrays
  (and the reference's global ``out_specs`` arrays) index positions.

``distributed/sharding.py`` says which slice of a leaf each position
holds.  ``make_production_mesh`` describes the reference's fleet meshes
(16 x 16 and 2 x 16 x 16 chips); nothing in the port runs them.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, e.g. ``Mesh(("data", "model"), (4, 2))``."""
    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")
        if any(int(s) < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes {self.axis_sizes}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, rank: int) -> tuple:
        """The mesh coordinate of ``rank``, row-major in axis order."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} on a mesh of {self.size}")
        out = []
        for n in reversed(self.axis_sizes):
            rank, c = divmod(rank, int(n))
            out.append(c)
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        """The rank at mesh coordinate ``coords`` (``coords``' inverse)."""
        if len(coords) != len(self.axis_sizes) or any(
                not 0 <= c < n for c, n in zip(coords, self.axis_sizes)):
            raise ValueError(f"coords {tuple(coords)} on {self.axis_sizes}")
        rank = 0
        for c, n in zip(coords, self.axis_sizes):
            rank = rank * int(n) + int(c)
        return rank


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's fleet mesh: ("data", "model") 16 x 16, or ("pod",
    "data", "model") 2 x 16 x 16 (a description: 256 or 512 chips)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_host_mesh() -> Mesh:
    """The degenerate 1 x 1 mesh."""
    return make_mesh((1, 1), ("data", "model"))


def make_test_mesh(data: int = 4, model: int = 2) -> Mesh:
    return make_mesh((data, model), ("data", "model"))
