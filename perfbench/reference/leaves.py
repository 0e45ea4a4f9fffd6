"""The declaration of a configuration's leaves, shared by its reference
module (which declares them, ``Dims.groups()``) and the harness's
``draw.py`` (which draws them).

A leaf is one tensor of the program's parameter tree: its name under its
group's dotted prefix, its shape, and the std of its normals, or None for
ones (a norm's scale).  A group is the leaves drawn together from one
generator, named by its tags.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf: its name under its group's prefix, its shape, and the
    std of its normals, or None for ones."""
    name: str
    shape: tuple
    std: float | None

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class Group:
    """Leaves drawn together: ``tags`` name the draw (and seed its
    generator), ``prefix`` begins each leaf's full dotted name."""
    tags: tuple
    prefix: str
    leaves: tuple
