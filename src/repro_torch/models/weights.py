"""Weights: the storage dtypes of the port's parameters, and carrying the
JAX package's parameters across.

The dtype rule.  ``repro`` keeps every parameter in ``param_dtype``
(float32) and casts each matrix to the compute dtype (bf16) where it is
used (``repro/models/layers.py:92,103,153-155,219,239-246``,
``repro/models/rglru.py:100-109``, ``repro/models/moe.py:59,79-82``).  The
port stores those matrices - every parameter of two or more dimensions:
the embedding table, the attention, MLP, RG-LRU in/out projections, the
conv kernel, the MoE router (d, E) and the experts' (E, d, f) and (E, f,
d) weights - already cast, once.
Casting once gives the values that casting at each use gives, and a decode
step then reads 5.3 GB of bf16 instead of 10.7 GB of float32 for
recurrentgemma-2b.  The vectors, which ``repro`` reads in float32 (norm
``scale``, ``w_a``, ``b_a``, ``w_i``, ``b_i``, ``lam``: ``layers.py:44``,
``rglru.py:81-85``), stay in ``param_dtype``: a bf16 round trip would
change them.  The rule is for serving only: a trainable model keeps
every parameter in ``param_dtype`` (``from_jax_params(...,
trainable=True)``), since AdamW on bf16 master weights is another result.

``_port_tree`` maps ``repro``'s layers by name whatever their block, so
an MoE layer's ``moe`` subtree (``router``, ``gate``, ``up``, ``down``)
comes across as it is.

Training state.  :func:`named` flattens ``repro``'s grouped pytree (its
params, or the mu / nu of its ``AdamWState``) into the port's parameter
names (``Model.named_parameters()``: ``embed``, ``layers.3.attn.wq``...);
:func:`grouped` maps such a dictionary (the port's grads, say) back to
``repro``'s layout, as numpy.
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


def _port_tree(cfg, params_np, dev):
    """``repro``'s grouped pytree as the port's nested dictionary, tensors
    on ``dev`` in the pytree's dtypes."""
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
    return params


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def named(cfg, tree_np, device="cuda") -> dict:
    """``repro``'s grouped pytree (numpy leaves) as {port parameter name:
    tensor on ``device``}, in the order of ``Model.named_parameters()``."""
    tree = _port_tree(cfg, tree_np, resolve_device(device))
    order = ["embed", "final_norm"] + ([] if cfg.tie_embeddings
                                       else ["lm_head"])
    flat = _flat(tree)
    return {k: flat[k] for k in order + [k for k in flat if k not in order]}


def grouped(cfg, flat: dict) -> dict:
    """{port parameter name: tensor} as ``repro``'s grouped pytree of
    numpy arrays (groups stacked over their leading axis)."""
    np_of = {k: v.detach().cpu().numpy() for k, v in flat.items()}
    P = len(cfg.block_pattern)

    def layer(i):
        out = {}
        for k, v in np_of.items():
            parts = k.split(".")
            if parts[0] == "layers" and int(parts[1]) == i:
                node = out
                for part in parts[2:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = v
        return out

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    tree = {"embed": {"table": np_of["embed"]},
            "final_norm": {"scale": np_of["final_norm"]},
            "groups": [stack([layer(g * P + pidx)
                              for g in range(cfg.n_groups)])
                       for pidx in range(P)],
            "tail": [layer(cfg.n_groups * P + t) for t in range(cfg.n_tail)]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"out": np_of["lm_head"]}
    return tree


def from_jax_params(cfg, params_np, device="cuda", *,
                    trainable: bool = False) -> Model:
    """The port's model with ``repro``'s weights.

    ``params_np`` is the pytree of ``repro.models.transformer.init``
    (``params``, not the axes) with numpy leaves: ``embed``,
    ``final_norm``, ``lm_head`` when untied, ``groups`` (one dict per
    pattern position, each leaf stacked over ``n_groups``) and ``tail``.
    Layer ``g * P + pidx`` takes ``groups[pidx]`` at ``g``; the tail
    follows.  A serving model stores them in the dtypes above; a
    ``trainable`` one keeps ``repro``'s float32 values as its parameters.
    """
    params = _port_tree(cfg, params_np, resolve_device(device))
    if trainable:
        return Model(cfg, params, trainable=True)
    return Model(cfg, stored(cfg, params))


def opt_state_from_jax(cfg, opt_np, device="cuda"):
    """``repro``'s ``AdamWState`` (step, mu, nu; numpy leaves) as the
    port's ``optim.AdamWState`` keyed by parameter name."""
    from ..optim import AdamWState
    dev = resolve_device(device)
    return AdamWState(
        step=torch.as_tensor(np.array(opt_np.step), dtype=torch.int32,
                             device=dev),
        mu=named(cfg, opt_np.mu, dev), nu=named(cfg, opt_np.nu, dev))
