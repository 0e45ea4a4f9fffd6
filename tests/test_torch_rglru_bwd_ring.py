"""The chunked RG-LRU backward's indexing, rehearsed on the CPU.

``linrec_bwd_chunked_kernel`` (``kernels/csrc/rglru_scan.cu``) gives each
block 32 channels of one batch row and walks S from the top chunk of TS
steps down.  TMA brings in boxes of (TS steps x 32 channels): a and g at
row t0 = k * TS, the float32 states one row earlier, so that row u holds
h_{t0+u-1}.  Rows and channels outside the tensor arrive as zeros, row -1
of the first chunk among them, where the chain takes h0 (or 0) instead.
The partial top chunk walks only its own steps.  da and db go into
output tiles, and the stores write only rows < S and channels < W.

``_bwd_ring`` below does that in plain PyTorch, step by step in the
kernel's order (dh = g + carry, da = dh h, db = dh, carry = dh a, all in
float32, each output rounded to the input type once).  It must equal
``linear_recurrence_bwd_plain`` bit for bit for every chunk length the
kernel could take (16, 32, 64), at S around the chunk boundaries, at a W
with a ragged last slice (40) and an even one (64), in float32 and
bfloat16, with and without h0, g and g_last.  The outputs start as NaN,
so an element the stores miss or write twice from a wrong tile shows.
The kernel itself runs only on the card (``chip_smoke.py`` phases 6 and
20); the plain version is held to ``repro``'s autodiff in
``tests/test_torch_rglru_train.py``, and once more here at a ragged shape.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch.kernels import rglru_scan as RS

CH = 32          # kBwdChannels: the channels a block owns


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations: one intra-op thread, so that test workers
    sharing the cores do not oversubscribe them (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box(x, t0, c0, TS):
    """The (B, TS, CH) box of x (B, S, W) at row t0 and channel c0, as TMA
    reads it: zeros where a row or channel lies outside the tensor."""
    B, S, W = x.shape
    out = torch.zeros((B, TS, CH), dtype=x.dtype)
    r0, r1 = max(t0, 0), min(t0 + TS, S)
    c1 = min(c0 + CH, W)
    if r1 > r0:
        out[:, r0 - t0:r1 - t0, :c1 - c0] = x[:, r0:r1, c0:c1]
    return out


def _store(y, tile, t0, c0):
    """A TMA store of the (B, TS, CH) tile into y at (t0, c0): nothing is
    written past S or W."""
    B, S, W = y.shape
    r1, c1 = min(t0 + tile.shape[1], S), min(c0 + CH, W)
    y[:, t0:r1, c0:c1] = tile[:, :r1 - t0, :c1 - c0]


def _bwd_ring(a, states, g, g_last, h0, TS):
    """linrec_bwd_chunked_kernel's walk, one block (32 channels of every
    batch row) at a time."""
    B, S, W = a.shape
    dt = a.dtype
    da = torch.full((B, S, W), float("nan"), dtype=dt)
    db = torch.full_like(da, float("nan"))
    dh0 = None if h0 is None else torch.full_like(h0, float("nan"))
    chunks = (S + TS - 1) // TS
    for c0 in range(0, W, CH):
        valid = torch.arange(c0, c0 + CH) < W

        def row(x):
            """(B, CH) of a (B, W) input, 0 past W (only channels < W
            read it)."""
            out = torch.zeros((B, CH), dtype=torch.float32)
            if x is not None:
                out[:, valid] = x[:, c0:min(c0 + CH, W)].float()
            return out

        h_init, carry = row(h0), row(g_last)
        for n in range(chunks):
            k = chunks - 1 - n
            t0 = k * TS
            ta = _box(a, t0, c0, TS).float()
            tg = None if g is None else _box(g, t0, c0, TS).float()
            ts = _box(states, t0 - 1, c0, TS)          # row u: h_{t0+u-1}
            tda = torch.full((B, TS, CH), float("nan"), dtype=dt)
            tdb = torch.full_like(tda, float("nan"))
            steps = min(TS, S - t0)
            for u in range(steps - 1, -1, -1):
                h = h_init if (k == 0 and u == 0) else ts[:, u]
                dh = carry if tg is None else tg[:, u] + carry
                tda[:, u] = (dh * h).to(dt)
                tdb[:, u] = dh.to(dt)
                carry = dh * ta[:, u]
            _store(da, tda, t0, c0)
            _store(db, tdb, t0, c0)
        if dh0 is not None:
            dh0[:, c0:min(c0 + CH, W)] = carry[:, valid].to(dt)
    return da, db, dh0


def _inputs(S, W, dtype, with_h0, with_g, with_g_last, seed=0, B=2):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_h0 else None
    g = rng.standard_normal((B, S, W)).astype(np.float32) if with_g else None
    g_last = (rng.standard_normal((B, W)).astype(np.float32)
              if with_g_last else None)

    def t(x):
        return None if x is None else torch.as_tensor(x).to(dtype)

    return tuple(map(t, (a, b, h0, g, g_last)))


RING_CASES = list(itertools.product(
    (16, 32, 64), (1, 15, 16, 37, 63, 64, 65, 129), (40, 64),
    ("float32", "bfloat16"), (False, True), (False, True), (False, True)))


@pytest.mark.parametrize(
    "TS,S,W,dtype,with_h0,with_g,with_g_last", RING_CASES)
def test_reverse_ring_equals_plain_bit_for_bit(TS, S, W, dtype, with_h0,
                                                with_g, with_g_last):
    a, b, h0, g, g_last = _inputs(S, W, getattr(torch, dtype), with_h0,
                                  with_g, with_g_last, seed=S * W + TS)
    states = RS._forward(a, b, h0, keep_states=True)[2]
    want = RS.linear_recurrence_bwd_plain(a, states, g, g_last, h0)
    got = _bwd_ring(a, states, g, g_last, h0, TS)
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        if y is None:
            assert x is None, name
            continue
        assert not torch.isnan(x).any(), f"{name}: an element not stored"
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_reverse_ring_matches_jax_autodiff_at_a_ragged_shape():
    """The rehearsal against jax.vjp of ``repro``'s scan, float32, at a
    partial top chunk (S = 65, TS = 64) and a ragged slice (W = 40)."""
    a, b, h0, g, g_last = _inputs(65, 40, torch.float32, True, True, True,
                                  seed=7)
    states = RS._forward(a, b, h0, keep_states=True)[2]
    got = _bwd_ring(a, states, g, g_last, h0, 64)
    (h, h_last), vjp = jax.vjp(JR.linear_recurrence, *(
        jnp.asarray(x.numpy()) for x in (a, b, h0)))
    want = vjp((jnp.asarray(g.numpy()), jnp.asarray(g_last.numpy())))
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_bwd_counts_launches_by_kernel_and_none_on_the_cpu():
    fn = RS.linear_recurrence_bwd
    assert set(fn.launches_by_kernel) == {"loop", "chunked"}
    before = (fn.launches, dict(fn.launches_by_kernel))
    a, b, h0, g, g_last = _inputs(37, 40, torch.bfloat16, True, True, True)
    states = RS._forward(a, b, h0, keep_states=True)[2]
    fn(a, states, g, g_last, h0)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (fn.launches, fn.launches_by_kernel) == before
