"""Weights and inputs drawn from ``--seed`` on the device.

Every draw has a generator of its own, seeded by a hash of the run's seed
and the draw's name, so a piece (one layer, one batch) can be drawn again
alone, to the bit, for the reference after the window.  A layer's matrices
come from one call (float32 normals times the configuration's
``init_std``, the port's and ``repro``'s initialisation), the embedding
table and the head from one call each; norm scales are ones.
"""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed for the draw named ``tags`` of run ``seed``
    (any whole number, however large)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def normal(dm, n: int, device, seed: int, *tags):
    g = generator(device, seed, *tags)
    return torch.randn(n, generator=g, device=device).mul_(dm.init_std)


def layer(dm, i: int, seed: int, device) -> dict:
    """Layer ``i``'s leaves, float32, under their short names: the
    matrices of ``dm.layer_matrices()`` from one draw, the vectors of
    ``dm.layer_vectors()`` ones."""
    flat = normal(dm, dm.layer_matrix_params(), device, seed, "layer", i)
    out = {name: torch.ones(dm.d, device=device)
           for name in dm.layer_vectors()}
    at = 0
    for name, (a, b) in dm.layer_matrices():
        out[name] = flat[at:at + a * b].view(a, b).clone()
        at += a * b
    return out


def embedding(dm, seed: int, device):
    return normal(dm, dm.vocab * dm.d, device, seed, "embed").view(
        dm.vocab, dm.d)


def leaves(dm, seed: int, device):
    """(name, float32 tensor) of every leaf under the port's parameter
    names (``embed``, ``final_norm``, ``lm_head``, ``layers.<i>.attn.wq``
    ...), in that order, drawn one layer at a time."""
    yield "embed", embedding(dm, seed, device)
    yield "final_norm", torch.ones(dm.d, device=device)
    if not dm.tied:
        yield "lm_head", head(dm, seed, device)
    for i in range(dm.layers):
        for k, v in layer(dm, i, seed, device).items():
            yield f"layers.{i}.{k}", v


def head(dm, seed: int, device):
    """The untied unembedding (d, vocab), float32."""
    return normal(dm, dm.d * dm.vocab, device, seed, "lm_head").view(
        dm.d, dm.vocab)


def weights(dm, seed: int, device, matrix_dtype=torch.float32) -> dict:
    """Every leaf of :func:`leaves`, matrices cast to ``matrix_dtype``
    (the dtype they are served in), vectors float32."""
    return {k: v.to(matrix_dtype) if v.ndim >= 2 else v
            for k, v in leaves(dm, seed, device)}
