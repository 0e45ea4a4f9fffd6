"""Weights and inputs drawn from ``--seed`` on the device.

A configuration's reference module declares every leaf of the program's
parameter tree (``Dims.groups()``): its dotted name, its shape and how it
is drawn, normals times a std that the configuration file states or ones
(a norm's scale).  Leaves sit in draw groups.  A group has a generator of
its own, seeded by a hash of the run's seed and the group's tags, and
draws its normal leaves in one call, sliced in their declared order; so
any group (one decoder layer, one tower block, the embedding table) can
be drawn again alone, to the bit, for the reference after the window.
The declaration's types, ``Leaf`` and ``Group``, are in
``perfbench/reference/leaves.py``.
"""
from __future__ import annotations

import hashlib

import torch

from perfbench.reference.leaves import Group


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed for the draw named ``tags`` of run ``seed``
    (any whole number, however large)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def draw_group(g: Group, seed: int, device) -> dict:
    """The group's leaves, float32, under their names within the group, in
    declared order: one draw of normals for all its normal leaves, each
    slice times its leaf's std."""
    n = sum(leaf.size for leaf in g.leaves if leaf.std is not None)
    flat = (torch.randn(n, generator=generator(device, seed, *g.tags),
                        device=device) if n else None)
    out, at = {}, 0
    for leaf in g.leaves:
        if leaf.std is None:
            out[leaf.name] = torch.ones(leaf.shape, device=device)
            continue
        out[leaf.name] = flat[at:at + leaf.size].view(leaf.shape).mul(
            leaf.std)
        at += leaf.size
    return out


def group(dm, tags: tuple, seed: int, device) -> dict:
    """The draw group named ``tags`` alone, as :func:`draw_group` gives it
    (the reference's blockwise passes draw each block again so)."""
    g = next((g for g in dm.groups() if g.tags == tags), None)
    if g is None:
        raise KeyError(f"no draw group {tags!r}")
    return draw_group(g, seed, device)


def layer(dm, i: int, seed: int, device) -> dict:
    """Decoder layer ``i``'s leaves under their short names."""
    return group(dm, ("layer", i), seed, device)


def leaves(dm, seed: int, device):
    """(full dotted name, float32 tensor) of every leaf, group by group in
    declared order, drawn one group at a time."""
    for g in dm.groups():
        for name, t in draw_group(g, seed, device).items():
            yield g.prefix + name, t


def weights(dm, seed: int, device, matrix_dtype=torch.float32) -> dict:
    """Every leaf of :func:`leaves`, matrices cast to ``matrix_dtype``
    (the dtype they are served in), vectors float32."""
    return {k: v.to(matrix_dtype) if v.ndim >= 2 else v
            for k, v in leaves(dm, seed, device)}
