"""The plain versions of the port's serving kernels against ``repro``: the
oracles in ``repro.kernels.ref`` and the Pallas kernels in interpret mode,
on shared numpy inputs, on the CPU.

On the CPU each wrapper (``flash_attention``, ``decode_attention``,
``linear_recurrence``, and ``kernels.ops`` above them) takes the plain
version; the CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.

Tolerances: float32 agrees to 2e-5 (summation order; the Pallas kernels'
online softmax).  bfloat16 inputs are computed in float32 on every side
and rounded to bf16 once, so outputs agree to one bf16 ulp of their
magnitude (2^-7 relative; 2e-2 absolute for attention outputs of order
one, the tolerance tests/test_kernels.py holds the Pallas kernels to).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.kernels.rglru_scan import linear_recurrence as pl_linrec
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rglru_scan import (linear_recurrence,
                                            linear_recurrence_plain)

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, dtype):
    """The same numpy array as a torch and a JAX array of ``dtype``."""
    tdt, jdt, _ = DTYPES[dtype]
    return torch.as_tensor(x).to(tdt), jnp.asarray(x, jdt)


def _check(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window
    (2, 64, 64, 4, 2, 32, True, 0),       # GQA, causal
    (1, 128, 128, 2, 1, 64, True, 32),    # sliding window, MQA
    (2, 64, 64, 3, 3, 32, False, 0),      # non-causal MHA
    (1, 32, 96, 4, 1, 64, True, 0),       # Sq < Sk: q at the last positions
    (1, 64, 64, 4, 2, 32, True, 64),      # window = S: same as causal
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_ref(case, dtype):
    B, Sq, Sk, H, KV, D, causal, window = case
    rng = np.random.default_rng(0)
    (tq, jq), (tk, jk), (tv, jv) = (
        _pair(_normal(rng, s), dtype)
        for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _check(got, ref.attention(jq, jk, jv, causal=causal, window=window),
           DTYPES[dtype][2])


@pytest.mark.pallas
@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[1] == c[2]])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_pallas_interpret(case, dtype):
    B, Sq, Sk, H, KV, D, causal, window = case
    rng = np.random.default_rng(1)
    (tq, jq), (tk, jk), (tv, jv) = (
        _pair(_normal(rng, s), dtype)
        for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    want = pl_flash(jq, jk, jv, causal=causal, window=window, block_q=32,
                    block_k=32, interpret=True)
    _check(flash_attention_plain(tq, tk, tv, causal=causal, window=window),
           want, DTYPES[dtype][2])


DECODE_CASES = [
    # B, S, H, KV, D, lengths
    (3, 64, 4, 2, 32, (64, 17, 1)),       # mixed lengths, GQA
    (2, 96, 6, 1, 64, (96, 40)),          # MQA (recurrentgemma-like)
    (2, 32, 4, 4, 32, (5, 32)),           # MHA
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_ref_and_pallas(case, dtype):
    B, S, H, KV, D, lengths = case
    rng = np.random.default_rng(2)
    (tq, jq), (tk, jk), (tv, jv) = (
        _pair(_normal(rng, s), dtype)
        for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    lens = np.asarray(lengths, np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.as_tensor(lens))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    _check(got, ref.decode_attention(jq, jk, jv, jnp.asarray(lens)), tol)
    _check(decode_attention_plain(tq, tk, tv, torch.as_tensor(lens)),
           pl_decode(jq, jk, jv, jnp.asarray(lens), block_k=32,
                     interpret=True), tol)


def test_decode_plain_equals_flash_at_the_last_position():
    """A decode query over a full cache is the last row of causal
    attention over the same keys."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(_normal(rng, (2, 1, 4, 32)))
    k = torch.as_tensor(_normal(rng, (2, 40, 2, 32)))
    v = torch.as_tensor(_normal(rng, (2, 40, 2, 32)))
    full = flash_attention_plain(q, k, v, causal=True)
    dec = decode_attention_plain(q[:, 0], k, v,
                                 torch.full((2,), 40, dtype=torch.int32))
    torch.testing.assert_close(dec, full[:, 0], atol=1e-6, rtol=1e-6)


LINREC_CASES = [
    # B, S, W, with h0
    (2, 64, 32, True),
    (1, 48, 40, False),
    (3, 1, 16, True),                     # one decode step
]


@pytest.mark.parametrize("case", LINREC_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_linear_recurrence_plain_matches_ref_and_pallas(case, dtype):
    B, S, W, with_h0 = case
    rng = np.random.default_rng(4)
    ta, ja = _pair(rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32),
                   dtype)
    tb, jb = _pair(_normal(rng, (B, S, W)), dtype)
    th0, jh0 = _pair(_normal(rng, (B, W)), dtype) if with_h0 \
        else (None, None)
    counts = (linear_recurrence.launches,
              dict(linear_recurrence.launches_by_kernel))
    h, h_last = ops.linear_recurrence(ta, tb, th0)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert counts == (linear_recurrence.launches,
                      linear_recurrence.launches_by_kernel)
    assert h.dtype == ta.dtype and h_last.shape == (B, W)
    assert torch.equal(h_last, h[:, -1])
    # a bf16 output differs by at most one ulp of its magnitude
    tol = 2e-5 if dtype == "float32" else 2 ** -7
    want_h, want_last = ref.linear_recurrence(ja, jb, jh0)
    _check(h, want_h, tol)
    _check(h_last, want_last, tol)
    pl_h, pl_last = pl_linrec(ja, jb, jh0, block_s=16, interpret=True)
    _check(linear_recurrence_plain(ta, tb, th0)[0], pl_h, tol)
    _check(h_last, pl_last, tol)


def test_wrappers_raise_off_cpu_and_cuda():
    """Dispatch is by device only: CPU -> plain version, CUDA -> kernel,
    anything else raises."""
    q = torch.empty((1, 8, 2, 64), device="meta")
    kv = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="not meta"):
        ops.attention(q, kv, kv)
    with pytest.raises(ValueError, match="not meta"):
        ops.decode_attention(q[:, 0], kv, kv,
                             torch.empty((1,), dtype=torch.int32,
                                         device="meta"))
    a = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="not meta"):
        ops.linear_recurrence(a, a)


def test_wrappers_check_their_inputs():
    x = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="dtype"):
        ops.attention(x.half(), x[:, :, :1].half(), x[:, :, :1].half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(x.transpose(1, 2).contiguous().transpose(1, 2),
                      x[:, :, :1].contiguous(), x[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(x[:, 0], x, x, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="h0"):
        ops.linear_recurrence(x[0], x[0], torch.zeros((3, 2)))


# ---------------------------------------------------------------------------
# The CUDA kernels' bf16 arithmetic, rehearsed on the CPU.  The two attention
# kernels run their products on the tensor cores: bf16 operands, float
# accumulation, the online softmax in float in the log2 domain, and P split
# into bf16 hi + lo halves before O += P V (rounding P once to bf16, as
# FA2/FA3 do, moves outputs of magnitude ~2^-8 by tens of ulps).  The
# emulations below repeat that arithmetic with the kernels' tile sizes and
# are held to the plain versions with the criterion chip_smoke.py holds the
# kernels to on the card: at most 2 bf16 ulps.

LOG2E = 1.4426950408889634


def _bf16_ulps(got, want):
    """chip_smoke.py::bf16_ulps: the largest |got - want| in bf16 ulps of
    want's magnitude, the ulp taken at no less than 2^-8's."""
    mag = want.float().abs().clamp_min(2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - want.float()).abs() / ulp).max())


def _pv(p, v, split):
    """P V as the kernels compute it: P rounded to bf16 hi (+ lo)."""
    hi = p.bfloat16().float()
    out = hi @ v
    if split:
        out = out + (p - hi).bfloat16().float() @ v
    return out


def _flash_emulated(q, k, v, *, window, split=True, bq=64, bk=64):
    """flash_wgmma_kernel's arithmetic: 64-query tiles against the 64-key
    tiles the causal and window masks leave, online softmax."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    off, c = Sk - Sq, D ** -0.5 * LOG2E
    qf = q.float().permute(0, 2, 1, 3)                      # (B, H, Sq, D)
    kf = k.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    out = torch.empty(B, H, Sq, D)
    for q0 in range(0, Sq, bq):
        Q = qf[:, :, q0:q0 + bq]
        qpos = torch.arange(q0, q0 + Q.shape[2])[:, None] + off
        q_lo, q_hi = q0 + off, q0 + Q.shape[2] - 1 + off
        k_begin = max(0, q_lo - window + 1) // bk * bk if window > 0 else 0
        m = torch.full(Q.shape[:3], -1e30)
        l = torch.zeros(Q.shape[:3])
        acc = torch.zeros(Q.shape)
        for k0 in range(k_begin, min(Sk, q_hi + 1), bk):
            kpos = torch.arange(k0, min(k0 + bk, Sk))[None, :]
            ok = (kpos <= qpos) & ((kpos > qpos - window) if window > 0
                                   else True)
            s = torch.where(ok, (Q @ kf[:, :, k0:k0 + bk].transpose(-1, -2))
                            * c, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _pv(p, vf[:, :, k0:k0 + bk], split)
            m = m_new
        out[:, :, q0:q0 + bq] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _decode_emulated(q, k_cache, v_cache, lengths, chunk=128, tile=64,
                     warps=4):
    """decode_kernel's arithmetic: 128-key chunks, each a ring of 64-key
    tiles of which warp w scores keys 16 w .. 16 w + 15 with its own
    online softmax; the warps merge, then the chunks."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G, c = H // KV, D ** -0.5 * LOG2E
    out = torch.empty(B, H, D)
    for b in range(B):
        n_len = int(lengths[b])
        for kvh in range(KV):
            Q = q[b, kvh * G:(kvh + 1) * G].float()
            K = k_cache[b, :, kvh].float()
            V = v_cache[b, :, kvh].float()
            parts = []
            for s0 in range(0, max(n_len, 1), chunk):
                ws = []
                for w in range(warps):
                    m = torch.full((G,), -1e30)
                    l = torch.zeros(G)
                    acc = torch.zeros(G, D)
                    for t in range(0, chunk, tile):
                        j0 = s0 + t + 16 * w
                        ok = (torch.arange(j0, j0 + 16) < n_len)[None, :]
                        if j0 >= S:
                            continue
                        s = torch.where(ok, (Q @ K[j0:j0 + 16].T) * c, -1e30)
                        m_new = torch.maximum(m, s.amax(-1))
                        corr = torch.exp2(m - m_new)
                        p = torch.where(ok, torch.exp2(s - m_new[:, None]),
                                        0.0)
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + _pv(p, V[j0:j0 + 16],
                                                        True)
                        m = m_new
                    ws.append((m, l, acc))
                M = torch.stack([x[0] for x in ws]).amax(0)
                wt = [torch.exp2(x[0] - M) for x in ws]
                parts.append((M, sum(x[1] * f for x, f in zip(ws, wt)),
                              sum(x[2] * f[:, None] for x, f in zip(ws, wt))))
            M = torch.stack([x[0] for x in parts]).amax(0)
            wt = [torch.exp2(x[0] - M) for x in parts]
            L = sum(x[1] * f for x, f in zip(parts, wt)).clamp_min(1e-30)
            A = sum(x[2] * f[:, None] for x, f in zip(parts, wt))
            out[b, kvh * G:(kvh + 1) * G] = A / L[:, None]
    return out.to(q.dtype)


def _bf16_normal(rng, shape):
    return torch.as_tensor(_normal(rng, shape)).bfloat16()


TENSOR_CORE_FLASH_CASES = [
    # B, S, H, KV, D, window
    (1, 1024, 2, 1, 256, 1024),           # the serving shape, cut down
    (1, 1025, 2, 1, 256, 1025),           # ragged: a 1-row query tile
    (1, 512, 4, 2, 64, 0),                # llama3.2-1b's D, GQA, causal
]


@pytest.mark.parametrize("case", TENSOR_CORE_FLASH_CASES)
def test_flash_tensor_core_rounding_within_2_ulps(case):
    B, S, H, KV, D, window = case
    rng = np.random.default_rng(5)
    q = _bf16_normal(rng, (B, S, H, D))
    k, v = (_bf16_normal(rng, (B, S, KV, D)) for _ in range(2))
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    got = _flash_emulated(q, k, v, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_ulps(got, want) <= 2.0


def test_rounding_p_once_to_bf16_breaks_the_2_ulp_bound():
    """Why the kernels split P: one bf16 rounding of P misses the bound."""
    B, S, H, KV, D, window = TENSOR_CORE_FLASH_CASES[0]
    rng = np.random.default_rng(5)
    q = _bf16_normal(rng, (B, S, H, D))
    k, v = (_bf16_normal(rng, (B, S, KV, D)) for _ in range(2))
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    assert _bf16_ulps(_flash_emulated(q, k, v, window=window, split=False),
                      want) > 2.0


def test_decode_tensor_core_rounding_within_2_ulps():
    rng = np.random.default_rng(6)
    B, S, H, KV, D = 4, 1024, 10, 1, 256
    q = _bf16_normal(rng, (B, H, D))
    kc, vc = (_bf16_normal(rng, (B, S, KV, D)) for _ in range(2))
    lengths = torch.tensor([1024, 1, 300, 777], dtype=torch.int32)
    want = decode_attention_plain(q, kc, vc, lengths)
    got = _decode_emulated(q, kc, vc, lengths)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_ulps(got, want) <= 2.0
