"""Model assembly: the block pattern unrolled into one list of layers, the
train / prefill / decode forward passes, and the training loss.

Counterpart of ``repro.models.transformer``.  JAX stacks each position of
the block pattern over its ``n_groups`` periods and scans; the port holds
the layers in execution order instead: layer ``g * P + pidx`` is
``groups[pidx][g]`` (P = the pattern's period), then the ``n_tail`` tail
layers, whose kinds are the pattern's first ones.

Block kinds ``attn``, ``local_attn``, ``rglru`` and ``moe`` (attention
and a top-k MoE MLP, ``models/moe.py``) are ported; ``mlstm`` and ``slstm``
raise ``NotImplementedError`` (ROADMAP.md, queue 1).
A forward takes tokens, looked up in the embedding table, or precomputed
embeddings (``embeds=``, the stubbed EnCodec frontend of musicgen-medium
and vision tower of qwen2-vl-2b), and optional positions: (B, S), or
(3, B, S) t / h / w streams under M-RoPE.

Serving and training hold their weights differently.  A serving model
stores matrices in the compute dtype, frozen (``models/weights.py``).  A
trainable model (``trainable=True``) holds every parameter as ``repro``
does, a float32 ``nn.Parameter`` that requires grad, cast to the compute
dtype at each use, so AdamW updates float32 master weights; its train
forward recomputes each layer in the backward (``torch.utils.checkpoint``)
when ``cfg.remat`` is set, as ``repro`` wraps each group in
``jax.checkpoint``.  Every ported block trains on the card: attention
(RoPE or M-RoPE) through the flash pair (``FlashAttention``, head dims 64,
128 and 256), the RG-LRU recurrence through its kernel pair
(``LinearRecurrence``), the rest through PyTorch's own autograd.  Under
remat each layer's forward runs twice (the forward, then the backward's
recomputation, which is the one that keeps its saved tensors) and its
backward once.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from ..device import resolve_device
from . import layers as L
from . import moe as M
from . import rglru as R

_INIT_SCALE = 0.02

# kind -> (apply, window of the kind under cfg)
BLOCKS = {
    "attn": (L.attn_layer, lambda cfg: 0),
    "local_attn": (L.attn_layer, lambda cfg: cfg.window),
    "rglru": (R.rglru_layer, lambda cfg: 0),
    "moe": (M.moe_layer, lambda cfg: 0),
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

    def __init__(self, tree, trainable=False):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _Tree(value, trainable))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=trainable))

    def __getitem__(self, name):
        return getattr(self, name)


class Model(nn.Module):
    """The layers of ``cfg`` in execution order, with the embedding table,
    the final norm and, when embeddings are not tied, the LM head.

    ``params``: {"embed": (vocab, d), "final_norm": (d,), ["lm_head":
    (d, vocab),] "layers": [one nested dict per layer, repro's names]},
    already in the storage dtypes of ``models/weights.py``, or, with
    ``trainable``, all in ``param_dtype``: the parameters then require
    grad.
    """

    def __init__(self, cfg, params, *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers for a "
                             f"{cfg.n_layers}-layer config")
        self.embed = nn.Parameter(params["embed"], requires_grad=trainable)
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=trainable)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Parameter(params["lm_head"],
                                     requires_grad=trainable))
        self.layers = nn.ModuleList(_Tree(p, trainable)
                                    for p in params["layers"])
        pdt = getattr(torch, cfg.param_dtype)
        bad = {p.dtype for p in self.parameters()} - {pdt}
        if trainable and bad:
            raise ValueError(f"a trainable model holds every parameter in "
                             f"param_dtype {pdt}; got {sorted(map(str, bad))}")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, batch: int, max_len: int):
        """Prefill/decode cache: one entry per layer and the next
        position ``t``.  Attention and MoE layers hold ``max_len`` slots,
        windowed layers ``min(max_len, window)``."""
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

    def forward(self, tokens=None, *, embeds=None, positions=None,
                cache=None, mode: str = "train", last_only: bool = False):
        """Exactly one of ``tokens`` (B, S) int, looked up in the embedding
        table, and ``embeds`` (B, S, d_model), cast to the compute dtype
        as ``repro`` casts them.  ``positions``: (B, S) int, or (3, B, S)
        under M-RoPE; by default they count on from the cache's ``t``, the
        same in all three streams.  Returns (logits, cache);
        ``last_only`` unembeds the last position only (B, 1, vocab)."""
        cfg = self.cfg
        if (tokens is None) == (embeds is None):
            raise ValueError("give exactly one of tokens and embeds")
        if tokens is not None:
            B, S = tokens.shape
            x = L.embed(self.embed, tokens, cfg)
        else:
            B, S = embeds.shape[:2]
            x = embeds.to(L.cdt(cfg))
        if positions is None:
            t0 = cache["t"] if cache is not None else 0
            positions = (t0 + torch.arange(S, dtype=torch.int32,
                                           device=x.device)).expand(B, S)
            if cfg.pos_type == "mrope":
                positions = positions.expand(3, B, S)
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        for i, (kind, p) in enumerate(zip(self.kinds, self.layers)):
            apply, window = BLOCKS[kind]
            if remat:
                # keep only the layer's input; the backward reruns it
                x = torch.utils.checkpoint.checkpoint(
                    lambda x, apply=apply, p=p, w=window(cfg): apply(
                        cfg, p, x, positions=positions, mode=mode,
                        window=w)[0],
                    x, use_reentrant=False)
                continue
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

    def prefill_step(self, tokens=None, cache=None, *, embeds=None,
                     positions=None):
        """Full-context forward over tokens or ``embeds`` that fills the
        cache.  Returns the last position's logits (B, 1, vocab), as
        ``repro``'s ``prefill_step`` does, but unembeds only that
        position."""
        return self.forward(tokens, embeds=embeds, positions=positions,
                            cache=cache, mode="prefill", last_only=True)

    def decode_step(self, tokens=None, cache=None, *, embeds=None,
                    positions=None):
        """One new token (B, 1), or one embedding (B, 1, d_model), against
        the cache."""
        return self.forward(tokens, embeds=embeds, positions=positions,
                            cache=cache, mode="decode")


class _LogZGold(torch.autograd.Function):
    """(logsumexp, gold logit) of each row of ``logits`` (..., vocab), in
    float32, with a backward written out so that it is deterministic on
    CUDA: ``softmax * dlogz`` plus ``dgold`` at each row's label, by an
    indexed write with exactly one index a row.  (Autograd of ``gather``
    goes through ``scatter_add_``, which PyTorch lists among CUDA's
    nondeterministic operations.)"""

    @staticmethod
    def forward(ctx, logits, labels):
        x = logits.float()
        logz = torch.logsumexp(x, dim=-1)
        gold = torch.gather(x, -1, labels[..., None].long())[..., 0]
        ctx.save_for_backward(logits, labels, logz)
        return logz, gold

    @staticmethod
    def backward(ctx, dlogz, dgold):
        logits, labels, logz = ctx.saved_tensors
        grad = torch.exp(logits.float() - logz[..., None]) * dlogz[..., None]
        flat = grad.view(-1, grad.shape[-1])
        rows = torch.arange(flat.shape[0], device=flat.device)
        flat[rows, labels.reshape(-1).long()] += dgold.reshape(-1)
        return grad.to(logits.dtype), None


def lm_loss(model, batch):
    """Next-token cross-entropy, the mean over valid positions, plus the
    1e-4 z-loss (``repro.models.transformer.lm_loss``).  ``batch`` has
    tokens (B, S) or embeds (B, S, d_model), labels (B, S), and optional
    positions ((B, S), or (3, B, S) under M-RoPE) and mask (B, S).
    Returns ``(loss + zloss, {"nll": loss, "zloss": zloss})``, float32
    scalars."""
    logits, _ = model(batch.get("tokens"), embeds=batch.get("embeds"),
                      positions=batch.get("positions"), mode="train")
    logz, gold = _LogZGold.apply(logits, batch["labels"])
    nll = logz - gold
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    # z-loss keeps logits bounded on long runs (Chowdhery et al.)
    zloss = 1e-4 * torch.sum((logz * mask) ** 2) / denom
    return loss + zloss, {"nll": loss, "zloss": zloss}


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
    if kind == "moe":
        # the experts take the place of the MLP (d_ff is their width)
        e, f = cfg.n_experts, cfg.d_ff
        p["ln2"] = _norm(d, dev)
        p["moe"] = {"router": _normal(gen, (d, e), dev),
                    "gate": _normal(gen, (e, d, f), dev),
                    "up": _normal(gen, (e, d, f), dev),
                    "down": _normal(gen, (e, f, d), dev)}
    elif cfg.d_ff:
        p["ln2"] = _norm(d, dev)
        p["mlp"] = _init_mlp(cfg, gen, dev)
    return p


def init(cfg, generator: torch.Generator, device="cuda", *,
         trainable: bool = False) -> Model:
    """Random weights of ``cfg``'s shapes, drawn as ``repro`` draws them
    (normal x 0.02 matrices, unit norms, zero gate biases, the RG-LRU's
    Lambda ramp) in float32 from ``generator``, which must live on
    ``device``, then stored in the dtypes of ``models/weights.py`` for
    serving, or kept in ``param_dtype`` as trainable parameters.  The
    values differ from JAX's: the tests carry JAX's weights across with
    ``weights.from_jax_params`` instead."""
    from .weights import stored   # weights imports this module for Model
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)

    def keep(tree):
        # drawn in float32, repro's param_dtype: a trainable model keeps
        # the draws as its master weights
        return tree if trainable else stored(cfg, tree)

    params = keep({
        "embed": _normal(generator, (cfg.vocab_size, cfg.d_model), dev),
        "final_norm": torch.ones(cfg.d_model, device=dev)})
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(_normal(
            generator, (cfg.d_model, cfg.vocab_size), dev))
    # one layer at a time, so a serving model holds one layer in float32
    params["layers"] = [keep(_init_layer(cfg, kind, generator, dev))
                        for kind in kinds]
    return Model(cfg, params, trainable=trainable)
