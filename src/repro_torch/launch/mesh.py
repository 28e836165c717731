"""Meshes as values: named axis sizes over one card.

The reference builds ``jax.sharding.Mesh`` objects over real devices
(``src/repro/launch/mesh.py``).  The port runs every mesh position on one
card: a mesh here is only its axis names and sizes, and state laid out
over it carries the mesh's axes as leading tensor dimensions, in the
mesh's axis order (``distributed/ecstore.py``: pages ``(A_data,
A_model, P, page)``).  ``distributed/sharding.py`` says which slice of a
leaf each position holds.

``make_production_mesh`` describes the reference's fleet meshes (16 x 16
and 2 x 16 x 16 chips); nothing in the port runs them on one card.
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
