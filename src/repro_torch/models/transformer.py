"""Model assembly: the block pattern unrolled into one list of layers, the
train / prefill / decode forward passes, and the training loss.

Counterpart of ``repro.models.transformer``.  JAX stacks each position of
the block pattern over its ``n_groups`` periods and scans; the port holds
the layers in execution order instead: layer ``g * P + pidx`` is
``groups[pidx][g]`` (P = the pattern's period), then the ``n_tail`` tail
layers, whose kinds are the pattern's first ones.

Every block kind of ``repro``'s registry is ported: ``attn``,
``local_attn``, ``rglru``, ``moe`` (attention and a top-k MoE MLP,
``models/moe.py``), and xLSTM's ``mlstm`` and ``slstm``
(``models/xlstm.py``); any other kind raises ``NotImplementedError``.
A forward takes tokens, looked up in the embedding table, or precomputed
embeddings (``embeds=``, the stubbed EnCodec frontend of musicgen-medium
and the backbone-only qwen2-vl-2b entry), and optional positions: (B, S),
or (3, B, S) t / h / w streams under M-RoPE.  A model with a vision tower
(``cfg.vision_layers``, Qwen2-VL: ``models/vision.py``) also takes
``pixels`` and ``grids``: it runs the tower over the step's packed
patches, merges them, splices the merged cells into the token embeddings
at the image pads, and computes the M-RoPE positions from the grids.

Serving and training hold their weights differently.  A serving model
stores matrices in the compute dtype, frozen (``models/weights.py``).  A
trainable model (``trainable=True``) holds every parameter as ``repro``
does, a float32 ``nn.Parameter`` that requires grad, cast to the compute
dtype at each use, so AdamW updates float32 master weights; its train
forward recomputes each layer in the backward (``torch.utils.checkpoint``)
when ``cfg.remat`` is set, as ``repro`` wraps each group in
``jax.checkpoint``.  Every ported block trains on the card: attention
(RoPE or M-RoPE) through the flash pair (``FlashAttention``, head dims 64,
128 and 256; the vision tower's 80 with segments), the RG-LRU recurrence
through its kernel pair (``LinearRecurrence``), the rest through
PyTorch's own autograd.  Under
remat each layer's forward runs twice (the forward, then the backward's
recomputation, which is the one that keeps its saved tensors) and its
backward once.
"""
from __future__ import annotations

import weakref

import torch
import torch.utils.checkpoint
from torch import nn

from .. import tracing
from ..device import resolve_device
from . import layers as L
from . import moe as M
from . import rglru as R
from . import vision as V
from . import xlstm as X

_INIT_SCALE = 0.02

# kind -> (apply, window of the kind under cfg)
BLOCKS = {
    "attn": (L.attn_layer, lambda cfg: 0),
    "local_attn": (L.attn_layer, lambda cfg: cfg.window),
    "rglru": (R.rglru_layer, lambda cfg: 0),
    "moe": (M.moe_layer, lambda cfg: 0),
    "mlstm": (X.mlstm_layer, lambda cfg: 0),
    "slstm": (X.slstm_layer, lambda cfg: 0),
}
BLOCK_SPANS = {kind: "block." + kind for kind in BLOCKS}


def _block(kind, cfg, p, x, **kw):
    """One layer of ``kind`` under its span."""
    with tracing.span(BLOCK_SPANS[kind]):
        return BLOCKS[kind][0](cfg, p, x, **kw)


def layer_kinds(cfg) -> list[str]:
    """The block kind of each layer, in execution order."""
    period = cfg.block_pattern
    kinds = [period[i % len(period)] for i in range(cfg.n_layers)]
    missing = sorted(set(kinds) - set(BLOCKS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {missing} are not ported (known: "
            f"{sorted(BLOCKS)}; ROADMAP.md)")
    return kinds


class Cache(dict):
    """A prefill/decode cache, ``{"layers": [...], "t": int}``: a dict the
    model that made it refers to weakly, to know when it is gone."""
    __slots__ = ("__weakref__",)


# Block kinds whose decode step a CUDA graph holds (``launch/steps.py``):
# their caches are written at a slot derived on the device from the
# position scalar.  The others (MoE routing, the recurrent states that
# xLSTM replaces) decode eagerly.
CAPTURABLE = frozenset({"attn", "local_attn"})


def _keeps_storage(dev, kinds) -> bool:
    """Whether a model of layer ``kinds`` on ``dev`` hands its next cache
    the storage of its last: where its decode step's graph, keyed on that
    storage, may engage."""
    return dev.type == "cuda" and set(kinds) <= CAPTURABLE


class _Tree(nn.Module):
    """A nested dictionary of tensors as a module: ``p["attn"]["wq"]``
    reads the same parameter as in ``repro``'s pytree; a list of
    dictionaries (the tower's ``blocks``) becomes a ``ModuleList``."""

    def __init__(self, tree, trainable=False):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _Tree(value, trainable))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(
                    _Tree(v, trainable) for v in value))
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
    with a vision tower also "vision" ({"patch_embed", "blocks": [...]})
    and "merger", already in the storage dtypes of ``models/weights.py``,
    or, with ``trainable``, all in ``param_dtype``: the parameters then
    require grad.
    """

    def __init__(self, cfg, params, *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        # the attention storage of the last cache (layer -> (k, v)), and
        # that cache, weakly (``init_cache``)
        self._kept, self._lent = {}, None
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
        if cfg.vision_layers:
            if len(params["vision"]["blocks"]) != cfg.vision_layers:
                raise ValueError(f"{len(params['vision']['blocks'])} tower "
                                 f"blocks for a {cfg.vision_layers}-block "
                                 f"config")
            self.vision = _Tree(params["vision"], trainable)
            self.merger = _Tree(params["merger"], trainable)
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
        windowed layers ``min(max_len, window)``; the recurrent layers
        (RG-LRU, mLSTM, sLSTM) their states.

        On CUDA, a model of ``CAPTURABLE`` layers only gives a new cache
        the storage of its last once that cache is gone, zeroed, where it
        fits: the same batch, at least ``max_len`` slots in an unwindowed
        layer (only the first ``t`` are read), the same size in a windowed
        one.  Where it does not, the old storage is freed and storage of
        the sizes asked for taken.  The decode
        step's CUDA graph is keyed on that storage
        (``launch/steps.py::DecodeGraph``), so one model's batches replay
        one graph.  A cache still referenced gets storage of its own."""
        cfg, dev = self.cfg, self.device
        recurrent = {"rglru": R.init_rglru_cache,
                     "mlstm": X.init_mlstm_cache,
                     "slstm": X.init_slstm_cache}
        sizes = [None if kind in recurrent
                 else min(max_len, cfg.window) if self._windowed(kind)
                 else max_len for kind in self.kinds]
        if _keeps_storage(dev, self.kinds) and (self._lent is None
                                                or self._lent() is None):
            return self._kept_cache(batch, sizes)
        return Cache(layers=[
            recurrent[kind](cfg, batch, device=dev) if size is None
            else L.init_kv_cache(cfg, batch, size, device=dev)
            for kind, size in zip(self.kinds, sizes)], t=0)

    def _windowed(self, kind) -> bool:
        return kind == "local_attn" and bool(self.cfg.window)

    def _kept_cache(self, batch, sizes):
        """A cache on the kept attention storage of ``sizes`` slots a
        layer (``init_cache``), zeroed, or on new storage where the kept
        one does not fit."""
        kept = self._kept

        def fits(i, size):
            k = kept[i][0]
            return k.shape[0] == batch and (
                k.shape[1] == size if self._windowed(self.kinds[i])
                else k.shape[1] >= size)

        if kept and all(fits(i, size) for i, size in enumerate(sizes)):
            for k, v in kept.values():
                k.zero_()
                v.zero_()
        else:
            if kept:
                kept.clear()
                # the old storage goes back to the card before the new is
                # taken: the allocator would otherwise hold it in its cache
                # until an allocation fails, then free it and retry
                torch.cuda.empty_cache()
            for i, size in enumerate(sizes):
                c = L.init_kv_cache(self.cfg, batch, size, device=self.device)
                kept[i] = (c["k"], c["v"])
        cache = Cache(layers=[{"k": k, "v": v, "pos": 0}
                              for k, v in kept.values()], t=0)
        self._lent = weakref.ref(cache)
        return cache

    def _images(self, tokens, x, pixels, grids, positions, cache, mode):
        """x with the merged image cells spliced in at the image pads,
        and the positions (the M-RoPE index of the grids where none are
        given)."""
        cfg = self.cfg
        if not cfg.vision_layers:
            raise ValueError(f"{cfg.name} has no vision tower: no pixels")
        if tokens is None or mode == "decode" or (
                cache is not None and cache["t"]):
            raise ValueError("pixels go with tokens, in a train or prefill "
                             "forward from position 0")
        grid = V.grid_list(cfg, grids)
        # the tokens reach the host behind the card's queue while the tower
        # is issued; the index is computed on the host as the tower runs
        host = V.HostCopy(tokens) if positions is None else None
        n = V.offsets(grid)[-1]
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        with tracing.span("model.vision", device=x.device, tokens=n):
            tracing.count("vision.attn_pairs", V.attention_pairs(grid))
            h = V.tower(cfg, self.vision, pixels, grid, remat)
        with tracing.span("model.merger"):
            x = V.splice(cfg, x, tokens, V.merge(cfg, self.merger, h))
        if host is not None:
            with tracing.span("model.mrope_index"):
                positions = V.to_device(
                    V.mrope_positions(cfg, host.get(), grid), x.device)
        return x, positions

    def forward(self, tokens=None, *, embeds=None, positions=None,
                cache=None, mode: str = "train", last_only: bool = False,
                t=None, pixels=None, grids=None):
        """Exactly one of ``tokens`` (B, S) int, looked up in the embedding
        table, and ``embeds`` (B, S, d_model), cast to the compute dtype
        as ``repro`` casts them.  ``positions``: (B, S) int, or (3, B, S)
        under M-RoPE; by default they count on from the cache's ``t``, the
        same in all three streams.  Decode takes that position as ``t``,
        an int32 device scalar (by default filled from the cache's ``t``),
        from which the layers derive theirs on the device
        (``layers.DecodeAt``); RoPE's tables are computed once for every
        layer (``layers.rotary``).  Returns (logits, cache); ``last_only``
        unembeds the last position only (B, 1, vocab).  ``pixels``
        (patches, vision_patch_dim), in the processor's merge-window order,
        and ``grids`` (images, 3: t, h, w in patches) go with tokens whose
        image pads take the merged cells, image after image."""
        cfg = self.cfg
        if (tokens is None) == (embeds is None):
            raise ValueError("give exactly one of tokens and embeds")
        with tracing.span("model.embed"):
            if tokens is not None:
                B, S = tokens.shape
                x = L.embed(self.embed, tokens, cfg)
            else:
                B, S = embeds.shape[:2]
                x = embeds.to(L.cdt(cfg))
        if pixels is not None:
            x, positions = self._images(tokens, x, pixels, grids, positions,
                                        cache, mode)
        at = None
        if mode == "decode":
            if t is None:
                t = torch.full((), cache["t"], dtype=torch.int32,
                               device=x.device)
            at = L.DecodeAt(t)
        if positions is None:
            if mode == "decode":
                t0 = t
            else:
                t0 = cache["t"] if cache is not None else 0
            positions = (t0 + torch.arange(S, dtype=torch.int32,
                                           device=x.device)).expand(B, S)
            if cfg.pos_type == "mrope":
                positions = positions.expand(3, B, S)
        # RoPE's tables once for every layer (None without rotation)
        positions = L.rotary(cfg, positions, x.device)
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        for i, (kind, p) in enumerate(zip(self.kinds, self.layers)):
            window = BLOCKS[kind][1](cfg)
            if remat:
                # keep only the layer's input; the backward reruns it (and
                # its spans)
                x = torch.utils.checkpoint.checkpoint(
                    lambda x, kind=kind, p=p, w=window: _block(
                        kind, cfg, p, x, positions=positions, mode=mode,
                        window=w)[0],
                    x, use_reentrant=False)
                continue
            x, _ = _block(kind, cfg, p, x, positions=positions,
                          cache=None if cache is None else cache["layers"][i],
                          mode=mode, window=window, at=at)
        with tracing.span("model.unembed"):
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
                    positions=None, t=None):
        """One new token (B, 1), or one embedding (B, 1, d_model), against
        the cache, at the position ``t`` (an int32 device scalar; by
        default filled from the cache's ``t``)."""
        return self.forward(tokens, embeds=embeds, positions=positions,
                            cache=cache, mode="decode", t=t)


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
    positions ((B, S), or (3, B, S) under M-RoPE), mask (B, S), and, for a
    model with a vision tower, pixels and grids (``Model.forward``).
    Returns ``(loss + zloss, {"nll": loss, "zloss": zloss})``, float32
    scalars."""
    logits, _ = model(batch.get("tokens"), embeds=batch.get("embeds"),
                      positions=batch.get("positions"), mode="train",
                      pixels=batch.get("pixels"), grids=batch.get("grids"))
    with tracing.span("model.loss"):
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


def _init_xlstm_layer(cfg, kind, gen, dev):
    """An mLSTM or sLSTM layer, with ``repro``'s gate biases: the mLSTM's
    forget bias 3 and input bias 0 a head, the sLSTM's (z, i, f, o) bias
    [0 (2d), 3 (d), 0 (d)]."""
    d = cfg.d_model
    if kind == "mlstm":
        inner, H = 2 * d, cfg.n_heads
        hd = inner // H
        return {"ln": _norm(d, dev), "up_v": _normal(gen, (d, inner), dev),
                "up_g": _normal(gen, (d, inner), dev),
                "wq": _normal(gen, (H, hd, hd), dev),
                "wk": _normal(gen, (H, hd, hd), dev),
                "wv": _normal(gen, (H, hd, hd), dev),
                "w_i": _normal(gen, (inner, H), dev),
                "b_i": torch.zeros(H, device=dev),
                "w_f": _normal(gen, (inner, H), dev),
                "b_f": torch.full((H,), 3.0, device=dev),
                "down": _normal(gen, (inner, d), dev)}
    bias = torch.zeros(4 * d, device=dev)
    bias[2 * d:3 * d] = 3.0
    return {"ln": _norm(d, dev), "w_in": _normal(gen, (d, 4 * d), dev),
            "w_rec": _normal(gen, (d, 4 * d), dev), "bias": bias,
            "down": _normal(gen, (d, d), dev)}


def _init_layer(cfg, kind, gen, dev):
    d = cfg.d_model
    if kind in ("mlstm", "slstm"):
        return _init_xlstm_layer(cfg, kind, gen, dev)
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
        if cfg.qkv_bias:
            p["attn"].update(bq=torch.zeros(qd, device=dev),
                             bk=torch.zeros(kvd, device=dev),
                             bv=torch.zeros(kvd, device=dev))
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


def _init_vision(cfg, gen, dev):
    """The tower and the merger: normal x 0.02 matrices, LayerNorm scales
    ones and shifts zeros, zero biases, as Hugging Face initialises
    them."""
    vd, f = cfg.vision_d, cfg.vision_ff
    md = cfg.vision_merge ** 2 * vd

    def ln(n):
        return {"scale": torch.ones(n, device=dev),
                "shift": torch.zeros(n, device=dev)}

    def zeros(n):
        return torch.zeros(n, device=dev)

    blocks = [{"ln1": ln(vd), "ln2": ln(vd),
               "attn": {"qkv": _normal(gen, (vd, 3 * vd), dev),
                        "qkv_b": zeros(3 * vd),
                        "proj": _normal(gen, (vd, vd), dev),
                        "proj_b": zeros(vd)},
               "mlp": {"fc1": _normal(gen, (vd, f), dev), "fc1_b": zeros(f),
                       "fc2": _normal(gen, (f, vd), dev), "fc2_b": zeros(vd)}}
              for _ in range(cfg.vision_layers)]
    vision = {"patch_embed": _normal(gen, (cfg.vision_patch_dim, vd), dev),
              "blocks": blocks}
    merger = {"ln": ln(vd), "fc1": _normal(gen, (md, md), dev),
              "fc1_b": zeros(md),
              "fc2": _normal(gen, (md, cfg.d_model), dev),
              "fc2_b": zeros(cfg.d_model)}
    return vision, merger


def init(cfg, generator: torch.Generator, device="cuda", *,
         trainable: bool = False) -> Model:
    """Random weights of ``cfg``'s shapes, drawn as ``repro`` draws them
    (normal x 0.02 matrices, unit norms, zero gate biases, the RG-LRU's
    Lambda ramp, the xLSTM forget biases of 3) in float32 from
    ``generator``, which must live on ``device``, then stored in the
    dtypes of ``models/weights.py`` for serving, or kept in
    ``param_dtype`` as trainable parameters.  The values differ from
    JAX's: the tests carry JAX's weights across with
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
    if cfg.vision_layers:
        params["vision"], params["merger"] = map(
            keep, _init_vision(cfg, generator, dev))
    return Model(cfg, params, trainable=trainable)
