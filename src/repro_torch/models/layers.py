"""Shared model layers: RMS norm, rotary embeddings (RoPE, and Qwen2-VL's
M-RoPE over three position streams), tied embed / unembed, the GQA
attention block with its KV cache, and the MLP.

Counterpart of ``repro.models.layers``, as functions over dictionaries of
tensors (``p``) with the JAX package's parameter names and layouts, so the
two are compared leaf by leaf.  Matrices are stored in the compute dtype
and vectors in float32 (``models/weights.py``), so every ``.to(dt)`` of a
matrix below is a no-op that returns the stored tensor: JAX casts its
float32 matrices at each use, the port once at load, with the same values.

The JAX package is functional and returns new caches; the port writes its
caches in place and keeps the write position as a Python int.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from .. import tracing
from ..kernels import ops


def cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# -- norms --------------------------------------------------------------------

def rms_norm(x, scale, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# -- rotary embeddings ---------------------------------------------------------

def rope_freqs(head_dim, theta, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (B, S, H, D); positions: (B, S) int.  Half-split rotation: the
    first D/2 features pair with the last D/2, as ``repro`` rotates."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions[..., None].float() * freqs              # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions, theta, sections):
    """Qwen2-VL M-RoPE.  x: (B, S, H, D); positions: (3, B, S) int, the
    t / h / w streams; ``sections`` split the D/2 rotary frequencies over
    the three streams in order.  Each frequency's angle is its stream's
    position times the frequency, selected by an index gather: ``repro``
    selects it with a one-hot ``einsum``, whose other two terms are exact
    zeros, so both give the same float32 angles."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    # the stream of each frequency, from device-side comparisons with the
    # sections' bounds (Python ints): a host list copied to the card would
    # block the host on the stream at every call
    j = torch.arange(d // 2, device=x.device)
    stream = torch.zeros_like(j)
    for bound in itertools.accumulate(sections[:-1]):
        stream += j >= bound                                 # (D/2,)
    pos = positions[stream].permute(1, 2, 0)                 # (B, S, D/2)
    ang = pos.float() * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope_qk(cfg, q, k, positions):
    """Rotate q and k by ``cfg.pos_type``, as ``repro``'s ``_rope_qk``:
    ``rope`` over (B, S) positions, ``mrope`` over (3, B, S) streams; any
    other type (``none``) leaves them."""
    if cfg.pos_type == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.pos_type == "mrope":
        return (apply_mrope(q, positions, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta,
                            cfg.mrope_sections))
    return q, k


# -- embedding / unembedding ---------------------------------------------------

def embed(table, tokens, cfg):
    return F.embedding(tokens, table.to(cdt(cfg)))


def unembed(head, table, x, cfg):
    """Logits of ``x``: against the embedding table when tied, else
    against the (d_model, vocab) head."""
    w = table.to(cdt(cfg)).T if cfg.tie_embeddings else head.to(cdt(cfg))
    return x @ w


# -- attention block -----------------------------------------------------------

def init_kv_cache(cfg, batch, max_len, *, device):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cdt(cfg), device=device),
            "v": torch.zeros(shape, dtype=cdt(cfg), device=device),
            "pos": 0}


def attention_block(cfg, p, x, *, positions, cache=None, mode="train",
                    window=0):
    """x: (B, S, d).  Returns (out, cache).

    train/prefill: (windowed-)causal attention over the sequence; prefill
    also fills the cache.  decode: S == 1, written into the cache (a ring
    buffer when windowed) and attended against it.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cdt(cfg)
    q = (x @ p["wq"].to(dt)).view(B, S, H, hd)
    k = (x @ p["wk"].to(dt)).view(B, S, KV, hd)
    v = (x @ p["wv"].to(dt)).view(B, S, KV, hd)
    q, k = _rope_qk(cfg, q, k, positions)

    if mode == "decode":
        assert cache is not None and S == 1
        pos = cache["pos"]
        size = cache["k"].shape[1]
        # Windowed layers keep a ring buffer: keys carry RoPE of their
        # absolute positions, so attention does not care about slot order.
        # The ring lines up because every prefill length is a multiple of
        # the window (repro/models/layers.py:173-176).
        slot = pos % size if window > 0 else min(pos, size - 1)
        # An indexed in-place write; repro writes through a one-hot mask,
        # which only keeps GSPMD's sharding, and gives the same values.
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        lengths = torch.full((B,), min(pos + 1, size), dtype=torch.int32,
                             device=x.device)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
        out = out[:, None]                                  # (B, 1, H, hd)
        cache["pos"] = pos + 1
    else:
        out = ops.attention(q, k, v, causal=True, window=window)
        if mode == "prefill":
            assert cache is not None
            size = cache["k"].shape[1]
            if window > 0 and size < S:
                # ring buffer: position p lives in slot p % size, so the
                # last ``size`` keys land rolled by S % size and decode's
                # next write (slot S % size) replaces the oldest
                kk = torch.roll(k[:, -size:], S % size, dims=1)
                vv = torch.roll(v[:, -size:], S % size, dims=1)
            else:
                kk, vv = k, v
            cache["k"][:, :kk.shape[1]] = kk
            cache["v"][:, :vv.shape[1]] = vv
            cache["pos"] = S
    out = out.reshape(B, S, H * hd)
    return out @ p["wo"].to(dt), cache


# -- MLP -----------------------------------------------------------------------

def mlp_block(cfg, p, x):
    dt = cdt(cfg)
    g = x @ p["gate"].to(dt)
    if cfg.mlp_variant == "swiglu":
        h = F.silu(g) * (x @ p["up"].to(dt))
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = F.gelu(g, approximate="tanh")
    return h @ p["down"].to(dt)


# -- standard transformer block (attn [+ local window] + MLP) ------------------

def attn_layer(cfg, p, x, *, positions, cache=None, mode="train", window=0):
    with tracing.span("block.attention"):
        h, cache = attention_block(
            cfg, p["attn"], rms_norm(x, p["ln1"]["scale"], cfg.norm_eps),
            positions=positions, cache=cache, mode=mode, window=window)
        x = x + h
    if cfg.d_ff:
        with tracing.span("block.mlp"):
            x = x + mlp_block(cfg, p["mlp"],
                              rms_norm(x, p["ln2"]["scale"], cfg.norm_eps))
    return x, cache
