"""The attention and recurrence hot spots the models call.

Counterpart of ``repro.kernels.ops``.  There the caller picks one of
several implementations with ``impl=`` (``cfg.attention_impl`` for
prefill), and the Pallas kernels are the TPU route.  The port has one
route per device, chosen in each kernel's wrapper: a CUDA tensor goes to
the hand-written kernel, a CPU tensor to the kernel's plain PyTorch
version, and any other device raises.  So there is no ``impl=`` knob, and
``ModelConfig.attention_impl``, kept in the copied dataclass, is not read.

    attention(q, k, v, *, causal=True, window=0, scale=None, segments=None)
        train / prefill attention; q (B, Sq, H, D), k, v (B, Sk, KV, D);
        ``segments``: offsets of packed segments (B = 1), each query
        seeing only its own segment's keys (a vision tower's images).
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

Each kernel wrapper counts its launches (``launches``, and
``launches_by_kernel`` where it splits them).  A CUDA graph replays the
kernels it captured without passing through the wrappers, so whoever
replays one counts its launches: ``launch_counts`` before the capture,
``launches_since`` after it, and ``count_launches`` at each replay.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention
from .flash_attention import FlashAttention, flash_attention
from .rglru_scan import LinearRecurrence
from .rglru_scan import linear_recurrence as _linear_recurrence


# the wrappers the models call, whose launches a graph's replay repeats
COUNTED = (flash_attention, decode_attention, _linear_recurrence)


def launch_counts():
    """Each counted wrapper's launches and launches by kernel, now."""
    return {fn: (fn.launches, dict(getattr(fn, "launches_by_kernel", {})))
            for fn in COUNTED}


def launches_since(before):
    """What each counted wrapper launched since ``before`` (a
    ``launch_counts``), in the same form."""
    return {fn: (n - before[fn][0],
                 {k: m - before[fn][1].get(k, 0) for k, m in by.items()})
            for fn, (n, by) in launch_counts().items()}


def count_launches(grew):
    """Add ``grew`` (a ``launches_since``) to the wrappers' counts: the
    launches of one replay of the graph whose capture made them."""
    for fn, (n, by) in grew.items():
        fn.launches += n
        for k, m in by.items():
            fn.launches_by_kernel[k] = fn.launches_by_kernel.get(k, 0) + m


def _records(*xs):
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, segments=None):
    if _records(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, scale, segments)
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, segments=segments)


def linear_recurrence(a, b, h0=None):
    if _records(a, b, h0):
        return LinearRecurrence.apply(a, b, h0)
    return _linear_recurrence(a, b, h0)


__all__ = ["attention", "decode_attention", "linear_recurrence"]
