"""The attention and recurrence hot spots the models call.

Counterpart of ``repro.kernels.ops``.  There the caller picks one of
several implementations with ``impl=`` (``cfg.attention_impl`` for
prefill), and the Pallas kernels are the TPU route.  The port has one
route per device, chosen in each kernel's wrapper: a CUDA tensor goes to
the hand-written kernel, a CPU tensor to the kernel's plain PyTorch
version, and any other device raises.  So there is no ``impl=`` knob, and
``ModelConfig.attention_impl``, kept in the copied dataclass, is not read.

    attention(q, k, v, *, causal=True, window=0, scale=None)
        train / prefill attention; q (B, Sq, H, D), k, v (B, Sk, KV, D).
        Where autograd records (grad enabled and an input requires grad)
        it goes through ``FlashAttention``: the forward kernel with LSE,
        then the backward kernel; otherwise (serving) the forward alone.
    decode_attention(q, k_cache, v_cache, lengths, *, scale=None)
        one new token; q (B, H, D), caches (B, S, KV, D), lengths (B,)
    linear_recurrence(a, b, h0=None)
        h_t = a_t * h_{t-1} + b_t over axis 1; a, b (B, S, W).  Where
        autograd records it goes through ``LinearRecurrence``: the forward
        kernel, which then also keeps its float32 states, then the
        backward kernel; otherwise (serving, decode) the forward alone.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention
from .flash_attention import FlashAttention, flash_attention
from .rglru_scan import LinearRecurrence
from .rglru_scan import linear_recurrence as _linear_recurrence


def _records(*xs):
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    if _records(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale)


def linear_recurrence(a, b, h0=None):
    if _records(a, b, h0):
        return LinearRecurrence.apply(a, b, h0)
    return _linear_recurrence(a, b, h0)


__all__ = ["attention", "decode_attention", "linear_recurrence"]
