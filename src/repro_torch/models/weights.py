"""Weights: the storage dtypes of the port's parameters, and carrying the
JAX package's parameters across.

The dtype rule.  ``repro`` keeps every parameter in ``param_dtype``
(float32) and casts each matrix to the compute dtype (bf16) where it is
used (``repro/models/layers.py:92,103,153-155,219,239-246``,
``repro/models/rglru.py:100-109``).  The port stores those matrices - every
parameter of two or more dimensions: the embedding table, the attention,
MLP, RG-LRU in/out projections and the conv kernel - already cast, once.
Casting once gives the values that casting at each use gives, and a decode
step then reads 5.3 GB of bf16 instead of 10.7 GB of float32 for
recurrentgemma-2b.  The vectors, which ``repro`` reads in float32 (norm
``scale``, ``w_a``, ``b_a``, ``w_i``, ``b_i``, ``lam``: ``layers.py:44``,
``rglru.py:81-85``), stay in ``param_dtype``: a bf16 round trip would
change them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .layers import cdt
from .transformer import Model


def stored(cfg, tree):
    """``tree`` (a tensor, or nested dicts and lists of them) in the port's
    storage dtypes: matrices in the compute dtype, vectors in
    ``param_dtype``."""
    if isinstance(tree, dict):
        return {k: stored(cfg, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [stored(cfg, v) for v in tree]
    dtype = cdt(cfg) if tree.ndim >= 2 else getattr(torch, cfg.param_dtype)
    return tree.to(dtype).contiguous()


def _tensors(tree, dev, index=None):
    """The numpy leaves of ``tree`` (at ``index`` of their leading axis) as
    tensors on ``dev``, copied: JAX hands out read-only buffers, which a
    CPU tensor would otherwise share."""
    if isinstance(tree, dict):
        return {k: _tensors(v, dev, index) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.as_tensor(np.array(a if index is None else a[index]),
                           device=dev)


def from_jax_params(cfg, params_np, device="cuda") -> Model:
    """The port's model with ``repro``'s weights.

    ``params_np`` is the pytree of ``repro.models.transformer.init``
    (``params``, not the axes) with numpy leaves: ``embed``,
    ``final_norm``, ``lm_head`` when untied, ``groups`` (one dict per
    pattern position, each leaf stacked over ``n_groups``) and ``tail``.
    Layer ``g * P + pidx`` takes ``groups[pidx]`` at ``g``; the tail
    follows.
    """
    dev = resolve_device(device)
    P = len(cfg.block_pattern)
    layers = []
    for i in range(cfg.n_layers):
        g, pidx = divmod(i, P)
        if g < cfg.n_groups:
            layers.append(_tensors(params_np["groups"][pidx], dev, g))
        else:
            layers.append(_tensors(params_np["tail"][i - cfg.n_groups * P],
                                   dev))
    params = {"embed": _tensors(params_np["embed"]["table"], dev),
              "final_norm": _tensors(params_np["final_norm"]["scale"], dev),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensors(params_np["lm_head"]["out"], dev)
    return Model(cfg, stored(cfg, params))
