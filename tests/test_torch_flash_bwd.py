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
The plain backward and the LSE also run at recurrentgemma-2b's head dim
256 (KV = 1), and the bf16 rehearsal below runs at D = 256 with the
instances' split of the output columns into 128-wide blocks.  The kernel
itself runs only on the card (``chip_smoke.py`` phase 16).
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
# recurrentgemma-2b's head dim (KV = 1, a window), for the backward and
# the LSE
CASES_D256 = [
    (1, 40, 2, 1, 256, True, 16),
    (2, 33, 4, 1, 256, True, 0),
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


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", CASES + CASES_D256)
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


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", CASES + CASES_D256)
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


# ---------------------------------------------------------------------------
# The bf16 kernels' arithmetic, rehearsed on the CPU.  flash_attention_bwd.cu
# runs its five products on the tensor cores: S and dP from bf16 operands
# with float sums, then P and dS in float, split into bf16 hi + lo halves
# before dQ += dS K, dV += P^T dO and dK += dS^T Q, with the kernels' 64 x 64
# tiles in their order (the dq kernel a query tile's key tiles; the dk/dv
# kernel a key tile's heads of the group and their query tiles) and one
# rounding to bf16 at the end.  The emulation is held to the plain version
# under the rule chip_smoke.py::bwd_agree holds the kernel to on the card.

LOG2E = 1.4426950408889634
TILE = 64


def _rounded_product(a, b, split, cols=None):
    """a b as the kernels issue it: a rounded to bf16 hi (+ lo = a - hi,
    rounded), b bf16, float sums; with ``cols``, b's columns in blocks of
    that many, one product each (the D = 256 instances' column split)."""
    if cols is not None and cols < b.shape[-1]:
        return torch.cat([_rounded_product(a, b[..., c:c + cols], split)
                          for c in range(0, b.shape[-1], cols)], dim=-1)
    hi = a.bfloat16().float()
    out = hi @ b
    if split:
        out = out + (a - hi).bfloat16().float() @ b
    return out


def _bwd_emulated(q, k, v, out, lse, dout, *, causal=True, window=0,
                  split_p=True, split_ds=True, cols=None):
    """dq_wgmma_kernel's and dkdv_wgmma_kernel's arithmetic; ``cols``: the
    output columns of a block (128 at D = 256), else all of D."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, off, scale = H // KV, Sk - Sq, D ** -0.5
    c = scale * LOG2E
    qf, of, dof = (x.float().reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
                   for x in (q, out, dout))               # (B, KV, G, Sq, D)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B, KV, Sk, D)
    lse2 = lse.reshape(B, Sq, KV, G).permute(0, 2, 3, 1) * LOG2E
    delta = (dof * of).sum(-1)                             # (B, KV, G, Sq)

    def visible(qpos, kpos):
        ok = (kpos < Sk) & (qpos < Sq + off)
        if causal:
            ok = ok & (kpos <= qpos)
        return ok & (kpos > qpos - window) if window > 0 else ok

    def p_ds(s, dp, ok, l2, dl):
        p = torch.where(ok, torch.exp2(s * c - l2), 0.0)
        return p, p * (dp - dl) * scale

    dq = torch.zeros(B, KV, G, Sq, D)
    for q0 in range(0, Sq, TILE):
        q1 = min(q0 + TILE, Sq)
        k_begin = (max(0, q0 + off - window + 1) // TILE * TILE
                   if window > 0 else 0)
        k_end = min(Sk, q1 + off) if causal else Sk
        for k0 in range(k_begin, k_end, TILE):
            k1 = min(k0 + TILE, Sk)
            K, V = kf[:, :, None, k0:k1], vf[:, :, None, k0:k1]
            ok = visible(torch.arange(q0, q1)[:, None] + off,
                         torch.arange(k0, k1)[None, :])
            _, ds = p_ds(qf[..., q0:q1, :] @ K.transpose(-1, -2),
                         dof[..., q0:q1, :] @ V.transpose(-1, -2), ok,
                         lse2[..., q0:q1, None], delta[..., q0:q1, None])
            dq[..., q0:q1, :] += _rounded_product(ds, K, split_ds, cols)
    dk, dv = torch.zeros(B, KV, Sk, D), torch.zeros(B, KV, Sk, D)
    for k0 in range(0, Sk, TILE):
        k1 = min(k0 + TILE, Sk)
        qi_end = (max(0, min(Sq, k0 + TILE - 1 + window - off))
                  if window > 0 else Sq)
        K, V = kf[:, :, k0:k1], vf[:, :, k0:k1]
        for g in range(G):
            qi_begin = max(0, k0 - off) // TILE * TILE if causal else 0
            for q0 in range(qi_begin, qi_end, TILE):
                q1 = min(q0 + TILE, Sq)
                Q, dO = qf[:, :, g, q0:q1], dof[:, :, g, q0:q1]
                ok = visible(torch.arange(q0, q1)[None, :] + off,
                             torch.arange(k0, k1)[:, None])
                pt, dst = p_ds(K @ Q.transpose(-1, -2),
                               V @ dO.transpose(-1, -2), ok,
                               lse2[:, :, g, None, q0:q1],
                               delta[:, :, g, None, q0:q1])
                dv[:, :, k0:k1] += _rounded_product(pt, dO, split_p, cols)
                dk[:, :, k0:k1] += _rounded_product(dst, Q, split_ds, cols)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _bwd_rule(got, want):
    """chip_smoke.py::bwd_agree's bf16 rule: the number of elements beyond
    both 2 bf16 ulps of the plain value and 2^-8 x max|plain| (must be 0),
    and the largest error in bf16 ulps where |plain| >= 2^-8 x max|plain|
    (must be at most 2)."""
    g, w = got.float(), want.float()
    diff, top = (g - w).abs(), float(w.abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -133)))
                     - 7)
    bad = int(((diff > 2 * ulp) & (diff > 2.0 ** -8 * top)).sum())
    big = w.abs() >= 2.0 ** -8 * top
    return bad, float((diff / ulp)[big].max())


TENSOR_CORE_BWD_CASES = [
    # B, Sq, Sk, H, KV, D, window, causal
    (1, 256, 256, 3, 1, 64, 0, True),    # GQA G = 3, causal
    (1, 256, 256, 6, 2, 128, 0, True),   # D = 128
    (1, 300, 300, 3, 1, 64, 96, True),   # a window, a ragged S
    (1, 200, 264, 3, 1, 64, 0, True),    # Sq < Sk, both ragged
    (1, 192, 192, 3, 1, 128, 64, True),  # D = 128 with a window
    (1, 200, 264, 3, 1, 64, 0, False),   # no mask, Sq < Sk, ragged
]


def _bf16_bwd_inputs(B, Sq, Sk, H, KV, D, window, causal, seed=7):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()

    q, k, v, dout = (bf16(B, Sq, H, D), bf16(B, Sk, KV, D),
                     bf16(B, Sk, KV, D), bf16(B, Sq, H, D))
    opts = dict(causal=causal, window=window)
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **opts)
    return (q, k, v, out, lse, dout), opts, flash_attention_bwd_plain(
        q, k, v, out, lse, dout, **opts)


@pytest.mark.parametrize("case", TENSOR_CORE_BWD_CASES)
def test_bwd_tensor_core_rounding_holds_the_bf16_rule(case):
    """With P and dS split into hi + lo, every gradient is within the rule,
    and within 1 bf16 ulp where |plain| >= 2^-8 x max|plain|."""
    args, opts, want = _bf16_bwd_inputs(*case)
    got = _bwd_emulated(*args, **opts)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        bad, ulps = _bwd_rule(g, w)
        assert bad == 0 and ulps <= 1.0


# Whether rounding P (dV's product) or dS (dQ's and dK's) once to bf16 puts
# elements outside both bounds of chip_smoke.py's elementwise rule: it does
# not, in any rehearsed case.  It does move the elements above 2^-8 of the
# largest by more than 2 ulps (18-63, against 1 with hi + lo), which
# bwd_agree's second bound rejects on the card, so the kernel keeps both
# lo halves.
SINGLE_ROUNDING_BREAKS_RULE = {"P": False, "dS": False}


@pytest.mark.parametrize("case", TENSOR_CORE_BWD_CASES)
@pytest.mark.parametrize("rounded_once", ["P", "dS"])
def test_bwd_single_rounding_of_p_or_ds_against_the_rule(case,
                                                         rounded_once):
    args, opts, want = _bf16_bwd_inputs(*case)
    got = _bwd_emulated(*args, **opts, split_p=rounded_once != "P",
                        split_ds=rounded_once != "dS")
    moved = ("dv",) if rounded_once == "P" else ("dq", "dk")
    results = {n: _bwd_rule(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                     got, want)}
    breaks = any(bad > 0 for bad, _ in results.values())
    assert breaks == SINGLE_ROUNDING_BREAKS_RULE[rounded_once]
    # the gradients it feeds move by more than 2 ulps, the others do not
    for name, (_, ulps) in results.items():
        assert (ulps > 2.0) == (name in moved), (name, ulps)


# D = 256 (recurrentgemma-2b's local attention, 10 query heads on one KV
# head): the instances split each kernel's output columns into two
# 128-wide blocks, each contracting all of D in S and dP.  Every output
# column is computed as without the split, so the emulation with blocks of
# 128 columns equals the unsplit one bit for bit and holds the same rule.
D256_BWD_CASES = [
    # B, Sq, Sk, H, KV, D, window, causal
    (1, 192, 192, 5, 1, 256, 0, True),   # GQA G = 5, causal
    (1, 200, 200, 2, 1, 256, 64, True),  # a window, a ragged S
]


@pytest.mark.parametrize("case", D256_BWD_CASES)
def test_bwd_tensor_core_rounding_at_d256_with_the_column_split(case):
    args, opts, want = _bf16_bwd_inputs(*case)
    got = _bwd_emulated(*args, **opts, cols=128)
    unsplit = _bwd_emulated(*args, **opts)
    for g, u, w in zip(got, unsplit, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(g, u)
        bad, ulps = _bwd_rule(g, w)
        assert bad == 0 and ulps <= 1.0
