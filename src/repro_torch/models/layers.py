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
caches in place.  Its positions are Python ints on the host (the cache's
``t``, each layer's ``pos``), which advance with every step; a decode step
also takes the position as an int32 device scalar, filled from the host's
count before the step, and derives the write slot, the valid length and
the RoPE positions from it on the device (``DecodeAt``), so that a CUDA
graph captured at one position replays at any other
(``launch/steps.py``).  RoPE's tables are computed once a forward
(``Rotary``) and shared by its layers.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

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


class Rotary(NamedTuple):
    """RoPE's cos and sin tables of one set of positions, (B, S, 1, D/2)
    float32, and the half-split rotation by them: the first D/2 features
    pair with the last D/2, as ``repro`` rotates.  A forward computes the
    tables once and every layer rotates its q and k by them."""
    cos: torch.Tensor
    sin: torch.Tensor

    @classmethod
    def of_angles(cls, ang):
        """The tables of (B, S, D/2) angles."""
        return cls(torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None])

    def __call__(self, x):
        """x: (B, S, H, D), rotated in float32, returned in its dtype."""
        cos, sin = self.cos, self.sin
        x1, x2 = torch.chunk(x.float(), 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return out.to(x.dtype)


def rope_angles(positions, theta, d, device):
    """(B, S, D/2) float32 angles of (B, S) int positions."""
    freqs = rope_freqs(d, theta, device)                     # (D/2,)
    return positions[..., None].float() * freqs


def mrope_angles(positions, theta, sections, d, device):
    """Qwen2-VL M-RoPE's angles from (3, B, S) int positions, the t / h /
    w streams; ``sections`` split the D/2 rotary frequencies over the
    three streams in order.  Each frequency's angle is its stream's
    position times the frequency, selected by an index gather: ``repro``
    selects it with a one-hot ``einsum``, whose other two terms are exact
    zeros, so both give the same float32 angles."""
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_freqs(d, theta, device)                     # (D/2,)
    # the stream of each frequency, from device-side comparisons with the
    # sections' bounds (Python ints): a host list copied to the card would
    # block the host on the stream at every call
    j = torch.arange(d // 2, device=device)
    stream = torch.zeros_like(j)
    for bound in itertools.accumulate(sections[:-1]):
        stream += j >= bound                                 # (D/2,)
    pos = positions[stream].permute(1, 2, 0)                 # (B, S, D/2)
    return pos.float() * freqs


def apply_rope(x, positions, theta):
    """x: (B, S, H, D); positions: (B, S) int."""
    return Rotary.of_angles(rope_angles(positions, theta, x.shape[-1],
                                        x.device))(x)


def apply_mrope(x, positions, theta, sections):
    """x: (B, S, H, D); positions: (3, B, S) int (``mrope_angles``)."""
    return Rotary.of_angles(mrope_angles(positions, theta, sections,
                                         x.shape[-1], x.device))(x)


def rotary(cfg, positions, device):
    """The ``Rotary`` tables of ``positions`` under ``cfg.pos_type``:
    ``rope`` over (B, S) positions, ``mrope`` over (3, B, S) streams;
    None for any other type (``none``), which leaves q and k."""
    d = cfg.head_dim
    if cfg.pos_type == "rope":
        return Rotary.of_angles(rope_angles(positions, cfg.rope_theta, d,
                                            device))
    if cfg.pos_type == "mrope":
        return Rotary.of_angles(mrope_angles(
            positions, cfg.rope_theta, cfg.mrope_sections, d, device))
    return None


def _rope_qk(rot, q, k):
    """Rotate q and k by the forward's ``Rotary`` tables (``rotary``), as
    ``repro``'s ``_rope_qk`` rotates them; None leaves them."""
    if rot is None:
        return q, k
    return rot(q), rot(k)


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


class DecodeAt:
    """A decode step's position ``t``, an int32 device scalar, and what a
    cache of ``size`` slots derives from it on the device: the write slot
    (a ring's ``t % size`` when windowed, else ``min(t, size - 1)``) and
    the valid lengths ``min(t + 1, size)`` of its B rows.  Made once a
    step and shared by its layers; no Python int of the position reaches
    a kernel, so a CUDA graph captured at one position replays at any
    other."""

    def __init__(self, t):
        self.t, self._where = t, {}

    def where(self, size, windowed, B):
        key = (size, windowed, B)
        if key not in self._where:
            t = self.t
            slot = t % size if windowed else t.clamp(max=size - 1)
            lengths = (t + 1).clamp(max=size).expand(B).contiguous()
            self._where[key] = (slot.long().view(1), lengths)
        return self._where[key]


def attention_block(cfg, p, x, *, positions, cache=None, mode="train",
                    window=0, at=None):
    """x: (B, S, d); ``positions``: the forward's ``Rotary`` tables of
    its positions (``rotary``; None where ``cfg.pos_type`` rotates
    nothing).  Returns (out, cache).

    q, k and v add their biases ``bq``, ``bk``, ``bv`` under
    ``cfg.qkv_bias`` (Qwen2; the output projection has none).

    train/prefill: (windowed-)causal attention over the sequence; prefill
    also fills the cache.  decode: S == 1, written into the cache (a ring
    buffer when windowed) at the step's position ``at`` (its
    ``DecodeAt``), and attended against it.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cdt(cfg)
    q, k, v = x @ p["wq"].to(dt), x @ p["wk"].to(dt), x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q, k, v = (q + p["bq"].to(dt), k + p["bk"].to(dt),
                   v + p["bv"].to(dt))
    q, k, v = (q.view(B, S, H, hd), k.view(B, S, KV, hd),
               v.view(B, S, KV, hd))
    q, k = _rope_qk(positions, q, k)

    if mode == "decode":
        assert cache is not None and at is not None and S == 1
        # Windowed layers keep a ring buffer: keys carry RoPE of their
        # absolute positions, so attention does not care about slot order.
        # The ring lines up because every prefill length is a multiple of
        # the window (repro/models/layers.py:173-176).
        slot, lengths = at.where(cache["k"].shape[1], window > 0, B)
        # An indexed in-place write; repro writes through a one-hot mask,
        # which only keeps GSPMD's sharding, and gives the same values.
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
        out = out[:, None]                                  # (B, 1, H, hd)
        cache["pos"] += 1
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

def attn_layer(cfg, p, x, *, positions, cache=None, mode="train", window=0,
               at=None):
    with tracing.span("block.attention"):
        h, cache = attention_block(
            cfg, p["attn"], rms_norm(x, p["ln1"]["scale"], cfg.norm_eps),
            positions=positions, cache=cache, mode=mode, window=window,
            at=at)
        x = x + h
    if cfg.d_ff:
        with tracing.span("block.mlp"):
            x = x + mlp_block(cfg, p["mlp"],
                              rms_norm(x, p["ln2"]["scale"], cfg.norm_eps))
    return x, cache
