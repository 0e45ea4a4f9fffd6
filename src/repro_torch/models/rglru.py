"""RecurrentGemma-style recurrent block: RG-LRU gated linear recurrence with a
short temporal conv (arXiv:2402.19427).

Counterpart of ``repro.models.rglru``:

    r_t = sigmoid(w_a * u_t + b_a)              (recurrence gate)
    i_t = sigmoid(w_i * u_t + b_i)              (input gate)
    log a_t = -c * softplus(lam) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

with the recurrence itself through ``kernels.ops.linear_recurrence`` (the
hand-written kernel on the card; where autograd records, the
``LinearRecurrence`` pair of forward and backward kernels).  The cache holds the conv history
``conv`` (B, conv_width - 1, W) in the compute dtype and the state ``h``
(B, W) in float32, and is updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import cdt, mlp_block, rms_norm

_C = 8.0


def init_rglru_cache(cfg, batch, *, device):
    w = cfg.lru_width
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=cdt(cfg), device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "pos": 0}


def _causal_conv(x, kernel, state=None):
    """Depthwise causal conv along seq. x: (B, S, W); kernel: (cw, W);
    state: (B, cw-1, W) history for decode.  Returns (out, new_state)."""
    cw = kernel.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+cw-1, W)
    S = x.shape[1]
    out = xp[:, 0:S] * kernel[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * kernel[i]
    new_state = xp[:, -(cw - 1):] if cw > 1 else pad
    return out, new_state


def rglru_core(cfg, p, u, h0=None):
    """u: (B, S, W) conv output.  Returns (y, h_last) in the compute dtype.

    The gates are float32 from float32 vectors (w_a, b_a, w_i, b_i, lam are
    stored in float32, never rounded to bf16), then a and b are rounded to
    the compute dtype for the recurrence.  h0 is rounded to the compute
    dtype too, as ``repro/models/rglru.py`` does, though the cache keeps h
    in float32: without that rounding bf16 decode drifts from the
    reference.
    """
    dt = cdt(cfg)
    uf = u.float()
    r = torch.sigmoid(uf * p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(uf * p["w_i"].float() + p["b_i"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * uf)
    return ops.linear_recurrence(a.to(dt), b.to(dt),
                                 None if h0 is None else h0.to(dt))


def rglru_layer(cfg, p, x, *, positions=None, cache=None, mode="train",
                window=0, at=None):
    """The recurrent block: norm -> (gate branch || conv + RG-LRU branch)
    -> out-proj -> + residual -> MLP.  Its state needs no position
    (``positions`` and decode's ``at`` are not read)."""
    dt = cdt(cfg)
    h_in = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    gate = F.gelu(h_in @ p["in_gate"].to(dt), approximate="tanh")
    u = h_in @ p["in_x"].to(dt)
    conv_state = cache["conv"] if cache is not None else None
    h0 = cache["h"] if cache is not None else None
    u, new_conv = _causal_conv(u, p["conv"].to(dt), conv_state)
    rec, h_last = rglru_core(cfg, p, u, h0)
    x = x + (rec * gate).to(dt) @ p["out"].to(dt)
    if cfg.d_ff:
        x = x + mlp_block(cfg, p["mlp"],
                          rms_norm(x, p["ln2"]["scale"], cfg.norm_eps))
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
        cache["pos"] += x.shape[1]
    return x, cache
