"""Model assembly: the block pattern unrolled into one list of layers, and
the train / prefill / decode forward passes.

Counterpart of ``repro.models.transformer``.  JAX stacks each position of
the block pattern over its ``n_groups`` periods and scans; the port holds
the layers in execution order instead: layer ``g * P + pidx`` is
``groups[pidx][g]`` (P = the pattern's period), then the ``n_tail`` tail
layers, whose kinds are the pattern's first ones.

Block kinds ``attn``, ``local_attn`` and ``rglru`` are ported; ``moe``,
``mlstm`` and ``slstm`` raise ``NotImplementedError`` (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from . import rglru as R

_INIT_SCALE = 0.02

# kind -> (apply, window of the kind under cfg)
BLOCKS = {
    "attn": (L.attn_layer, lambda cfg: 0),
    "local_attn": (L.attn_layer, lambda cfg: cfg.window),
    "rglru": (R.rglru_layer, lambda cfg: 0),
}


def layer_kinds(cfg) -> list[str]:
    """The block kind of each layer, in execution order."""
    period = cfg.block_pattern
    kinds = [period[i % len(period)] for i in range(cfg.n_layers)]
    missing = sorted(set(kinds) - set(BLOCKS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {missing} are not ported yet "
            f"(ROADMAP.md, queue 1)")
    return kinds


class _Tree(nn.Module):
    """A nested dictionary of tensors as a module: ``p["attn"]["wq"]``
    reads the same parameter as in ``repro``'s pytree."""

    def __init__(self, tree):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _Tree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)


class Model(nn.Module):
    """The layers of ``cfg`` in execution order, with the embedding table,
    the final norm and, when embeddings are not tied, the LM head.

    ``params``: {"embed": (vocab, d), "final_norm": (d,), ["lm_head":
    (d, vocab),] "layers": [one nested dict per layer, repro's names]},
    already in the storage dtypes of ``models/weights.py``.
    """

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers for a "
                             f"{cfg.n_layers}-layer config")
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Parameter(params["lm_head"], requires_grad=False))
        self.layers = nn.ModuleList(_Tree(p) for p in params["layers"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, batch: int, max_len: int):
        """Prefill/decode cache: one entry per layer and the next
        position ``t``.  Windowed layers hold ``min(max_len, window)``
        slots."""
        cfg, dev = self.cfg, self.device
        caches = []
        for kind in self.kinds:
            if kind == "rglru":
                caches.append(R.init_rglru_cache(cfg, batch, device=dev))
            else:
                size = max_len
                if kind == "local_attn" and cfg.window:
                    size = min(max_len, cfg.window)
                caches.append(L.init_kv_cache(cfg, batch, size, device=dev))
        return {"layers": caches, "t": 0}

    def forward(self, tokens, *, cache=None, mode: str = "train",
                last_only: bool = False):
        """tokens: (B, S) int.  Returns (logits, cache); ``last_only``
        unembeds the last position only (B, 1, vocab).  Positions count
        on from the cache's ``t``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = L.embed(self.embed, tokens, cfg)
        t0 = cache["t"] if cache is not None else 0
        positions = (t0 + torch.arange(S, dtype=torch.int32,
                                       device=tokens.device)).expand(B, S)
        for i, (kind, p) in enumerate(zip(self.kinds, self.layers)):
            apply, window = BLOCKS[kind]
            x, _ = apply(cfg, p, x, positions=positions,
                         cache=None if cache is None else cache["layers"][i],
                         mode=mode, window=window(cfg))
        if last_only:
            x = x[:, -1:]
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = L.unembed(self.lm_head, self.embed, x, cfg)
        if cache is not None:
            cache["t"] += S
        return logits, cache

    def prefill_step(self, tokens, cache):
        """Full-context forward that fills the cache.  Returns the last
        position's logits (B, 1, vocab), as ``repro``'s ``prefill_step``
        does, but unembeds only that position."""
        return self.forward(tokens, cache=cache, mode="prefill",
                            last_only=True)

    def decode_step(self, tokens, cache):
        """One new token (B, 1) against the cache."""
        return self.forward(tokens, cache=cache, mode="decode")


def _normal(gen, shape, dev):
    return _INIT_SCALE * torch.randn(shape, generator=gen, device=dev)


def _init_mlp(cfg, gen, dev):
    d, f = cfg.d_model, cfg.d_ff
    p = {"gate": _normal(gen, (d, f), dev)}
    if cfg.mlp_variant == "swiglu":
        p["up"] = _normal(gen, (d, f), dev)
    p["down"] = _normal(gen, (f, d), dev)
    return p


def _norm(d, dev):
    return {"scale": torch.ones(d, device=dev)}


def _init_layer(cfg, kind, gen, dev):
    d = cfg.d_model
    if kind == "rglru":
        w = cfg.lru_width
        # Lambda so that a^c lands in (0.9, 0.999), as repro initialises it
        lam = torch.log(torch.expm1(
            -torch.log(torch.linspace(0.9, 0.999, w, device=dev)) / 8.0))
        p = {"ln1": _norm(d, dev), "in_x": _normal(gen, (d, w), dev),
             "in_gate": _normal(gen, (d, w), dev),
             "conv": _normal(gen, (cfg.conv_width, w), dev),
             "w_a": _normal(gen, (w,), dev),
             "b_a": torch.zeros(w, device=dev),
             "w_i": _normal(gen, (w,), dev),
             "b_i": torch.zeros(w, device=dev), "lam": lam,
             "out": _normal(gen, (w, d), dev)}
    else:
        qd, kvd = cfg.q_dim, cfg.kv_dim
        p = {"ln1": _norm(d, dev), "attn": {
            "wq": _normal(gen, (d, qd), dev), "wk": _normal(gen, (d, kvd), dev),
            "wv": _normal(gen, (d, kvd), dev), "wo": _normal(gen, (qd, d), dev)}}
    if cfg.d_ff:
        p["ln2"] = _norm(d, dev)
        p["mlp"] = _init_mlp(cfg, gen, dev)
    return p


def init(cfg, generator: torch.Generator, device="cuda") -> Model:
    """Random weights of ``cfg``'s shapes, drawn as ``repro`` draws them
    (normal x 0.02 matrices, unit norms, zero gate biases, the RG-LRU's
    Lambda ramp) in float32 from ``generator``, which must live on
    ``device``, then stored in the dtypes of ``models/weights.py``.  The
    values differ from JAX's: the tests carry JAX's weights across with
    ``weights.from_jax_params`` instead."""
    from .weights import stored   # weights imports this module for Model
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)
    params = stored(cfg, {
        "embed": _normal(generator, (cfg.vocab_size, cfg.d_model), dev),
        "final_norm": torch.ones(cfg.d_model, device=dev)})
    if not cfg.tie_embeddings:
        params["lm_head"] = stored(cfg, _normal(
            generator, (cfg.d_model, cfg.vocab_size), dev))
    # one layer at a time, so only one layer is ever held in float32
    params["layers"] = [stored(cfg, _init_layer(cfg, kind, generator, dev))
                        for kind in kinds]
    return Model(cfg, params)
