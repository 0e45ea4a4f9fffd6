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
from repro_torch.kernels.rglru_scan import linear_recurrence_plain

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
    h, h_last = ops.linear_recurrence(ta, tb, th0)
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
