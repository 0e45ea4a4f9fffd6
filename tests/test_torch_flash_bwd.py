"""The flash-attention backward of the port against ``repro``'s on the CPU.

``flash_attention_bwd_plain`` (the plain version of the backward kernel,
``kernels/csrc/flash_attention_bwd.cu``) and the ``FlashAttention``
autograd Function, which on the CPU pairs the plain forward with it, are
held to ``jax.grad`` of ``repro.kernels.ref.attention`` and to the VJP of
``repro.kernels.ops.flash_attention_xla`` (its hand-written ``_flash_bwd``)
on the same numpy inputs: causal, sliding window and GQA, in float32, at
rtol 1e-5 and atol 1e-6 x the largest element of the tensor (summation
order only).  The atol scales with the tensor because the gradients
cancel: a query that sees one key has dq = 0 exactly, and both sides
round dP - delta to +-1 ulp of dP, which leaves noise of the size of
ulp(|dP|) x |k| (~1e-6 at unit inputs) and of either sign.  The forward's
log-sum-exp is held to ``_flash_fwd_shaped``'s at rtol 1e-5 / atol 1e-6.
The kernel itself runs only on the card (``chip_smoke.py`` phase 16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.kernels import ops as TO
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

RTOL, ATOL = 1e-5, 1e-6

CASES = [
    # B, S, H, KV, D, causal, window
    (2, 64, 4, 4, 16, True, 0),
    (2, 48, 6, 2, 16, True, 0),      # GQA, G = 3
    (1, 80, 4, 1, 32, True, 24),     # GQA + sliding window
    (2, 40, 4, 2, 8, False, 0),      # no mask
]


def _inputs(B, S, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, dout


def _close(got, want, scaled=True):
    want = np.asarray(want)
    atol = ATOL * (np.abs(want).max() if scaled else 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=atol)


def _jax_grads(fn, q, k, v, dout):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(dout))


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", CASES)
def test_plain_backward_matches_jax(B, S, H, KV, D, causal, window):
    q, k, v, dout = _inputs(B, S, H, KV, D)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, dout))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                    causal=causal, window=window)
    want_ref = _jax_grads(lambda a, b, c: JR.attention(
        a, b, c, causal=causal, window=window), q, k, v, dout)
    want_xla = _jax_grads(lambda a, b, c: JO.flash_attention_xla(
        a, b, c, causal, window, None, 16, 16), q, k, v, dout)
    for g, wr, wx in zip(got, want_ref, want_xla):
        assert g.dtype == torch.float32
        _close(g, wr)
        _close(g, wx)


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", CASES)
def test_autograd_function_matches_jax(B, S, H, KV, D, causal, window):
    q, k, v, dout = _inputs(B, S, H, KV, D, seed=1)
    tq, tk, tv = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    out = FlashAttention.apply(tq, tk, tv, causal, window, None)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(dout))
    want_out, vjp = jax.vjp(lambda a, b, c: JO.flash_attention_xla(
        a, b, c, causal, window, None, 16, 16), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    _close(out, want_out, scaled=False)
    for g, w in zip(got, vjp(jnp.asarray(dout))):
        _close(g, w)


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", CASES)
def test_forward_lse_matches_flash_fwd_shaped(B, S, H, KV, D, causal,
                                              window):
    q, k, v, _ = _inputs(B, S, H, KV, D, seed=2)
    _, lse = flash_attention_plain(*(torch.as_tensor(x) for x in (q, k, v)),
                                   causal=causal, window=window,
                                   return_lse=True)
    _, want = JO._flash_fwd_shaped(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, window,
                                   D ** -0.5, 16, 16)
    assert lse.shape == (B, S, H) and lse.dtype == torch.float32
    _close(lse, want, scaled=False)


def test_ops_attention_routes_through_the_function_only_for_grad():
    """``ops.attention`` records the autograd Function when an input needs
    a gradient and calls the forward alone otherwise (serving)."""
    q, k, v, dout = (torch.as_tensor(x) for x in _inputs(1, 32, 4, 2, 8))
    plain = TO.attention(q, k, v)
    assert plain.grad_fn is None
    tq = q.clone().requires_grad_()
    out = TO.attention(tq, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    with torch.no_grad():
        assert TO.attention(tq, k, v).grad_fn is None
    (dq,) = torch.autograd.grad(out, (tq,), dout)
    assert dq.shape == q.shape


def test_bf16_plain_backward_rounds_the_float32_gradients():
    """In bfloat16 the plain backward computes in float32 from the bf16
    inputs and rounds each gradient once."""
    q, k, v, dout = (torch.as_tensor(x).to(torch.bfloat16)
                     for x in _inputs(2, 48, 6, 2, 16, seed=3))
    out, lse = flash_attention_plain(q, k, v, return_lse=True)
    got = flash_attention_bwd_plain(q, k, v, out, lse, dout)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     out.float(), lse, dout.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def test_backward_checks_its_inputs():
    q, k, v, dout = (torch.as_tensor(x) for x in _inputs(1, 16, 4, 2, 8))
    out, lse = flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd(q, k, v, out, lse[:, :8], dout)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse, dout[:, :8])
    with pytest.raises(ValueError, match="runs on cuda"):
        flash_attention_bwd(*(x.to("meta") for x in (q, k, v, out, lse,
                                                     dout)))
