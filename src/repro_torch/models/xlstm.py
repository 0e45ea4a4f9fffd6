"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory, sequential) with exponential gating and stabilizers.

Counterpart of ``repro.models.xlstm``, with ``repro.kernels.ref``'s
step-by-step mLSTM (``mlstm_recurrent`` here), which decode runs.  The
mLSTM block up-projects 2x from a pre-norm, applies the cell over heads
(per-head width ``2 * d_model // n_heads``, not ``cfg.head_dim``), gates
the output with silu and projects down; it has no separate MLP.  The sLSTM
block runs a fused (z, i, f, o) input projection, then the recurrence one
step at a time.

``repro`` has no Pallas kernel here, and neither has the port: every loop
is a Python loop over chunks (mLSTM) or steps (sLSTM) of plain PyTorch
operations.  The mLSTM products and the sLSTM scan run in float32, as in
``repro``.  Two choices keep a run's gradients bit-identical on CUDA: the
in-chunk running maximum of the stabilizer is a doubling scan of
``torch.maximum`` (``torch.cummax``'s backward accumulates with atomics),
and chunk maxima use ``torch.amax``; both split a gradient evenly between
tied elements, as JAX's ``maximum`` and ``max`` do.

Caches are dictionaries updated in place: mLSTM (C, n, m) in float32
(B, H, D, D) / (B, H, D) / (B, H), m starting at -1e30; sLSTM (h, c, n, m)
(B, d) in float32.  ``pos`` is a Python int.  The blocks need no position:
``positions`` and decode's device position ``at`` are not read.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import cdt, rms_norm

_M_INIT = -1e30   # the stabilizer's start (repro's caches and chunk scan)


def _head_width(cfg) -> int:
    return (2 * cfg.d_model) // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm_cache(cfg, batch, *, device):
    H, hd = cfg.n_heads, _head_width(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), _M_INIT, **f32), "pos": 0}


def mlstm_recurrent(q, k, v, log_f, log_i, *, c0=None, n0=None, m0=None,
                    eps: float = 1e-6):
    """The mLSTM run one step at a time (``repro.kernels.ref.
    mlstm_chunkwise``, the oracle of the chunkwise form):

        m_t = max(log_f_t + m_{t-1}, log_i_t)
        C_t = exp(log_f_t + m_{t-1} - m_t) C_{t-1} + exp(log_i_t - m_t) k_t v_t^T
        n_t = exp(log_f_t + m_{t-1} - m_t) n_{t-1} + exp(log_i_t - m_t) k_t
        h_t = C_t^T q_t / (max(|n_t . q_t|, exp(-m_t)) + eps)

    with q scaled by D^-0.5.  q, k, v: (B, S, H, D); log_f, log_i: (B, S,
    H).  The state starts at (c0, n0, m0), else zeros and m = -inf.
    Returns (out (B, S, H, D) in q's dtype, (C, n, m) in float32)."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    q32, k32, v32 = (x.float() for x in (q, k, v))
    lf, li = log_f.float(), log_i.float()
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.zeros((b, h, d, d), **f32) if c0 is None else c0.float()
    n = torch.zeros((b, h, d), **f32) if n0 is None else n0.float()
    m = torch.full((b, h), -torch.inf, **f32) if m0 is None else m0.float()
    outs = []
    for t in range(s):
        kt, vt, lft, lit = k32[:, t], v32[:, t], lf[:, t], li[:, t]
        m_new = torch.maximum(lft + m, lit)
        fg = torch.exp(lft + m - m_new)[..., None]           # (B, H, 1)
        ig = torch.exp(lit - m_new)[..., None]
        # fg C + (ig k) v^T: the outer product as a K = 1 batched product,
        # added in place to the new fg C
        C = fg[..., None] * C
        C.view(b * h, d, d).baddbmm_((ig * kt).view(b * h, d, 1),
                                     vt.reshape(b * h, 1, d))
        n = fg * n + ig * kt
        qs = q32[:, t] * scale
        num = (qs[..., None, :] @ C)[..., 0, :]              # C^T q
        den = torch.maximum(torch.abs(torch.sum(n * qs, -1)),
                            torch.exp(-m_new))[..., None] + eps
        outs.append(num / den)
        m = m_new
    return torch.stack(outs, 1).to(q.dtype), (C, n, m)


def _cummax(x):
    """Running maximum along the last axis: a doubling (Hillis-Steele)
    scan of ``torch.maximum``, exact in value."""
    k, size = 1, x.shape[-1]
    while k < size:
        x = torch.cat([x[..., :k], torch.maximum(x[..., k:], x[..., :-k])],
                      -1)
        k *= 2
    return x


def mlstm_chunkwise_parallel(q, k, v, log_f, log_i, *, chunk: int = 256,
                             eps: float = 1e-6):
    """The chunkwise-parallel mLSTM (``repro.models.xlstm``): a sequential
    loop over chunks of ``chunk`` steps (halved until it divides S),
    parallel inside each chunk.  Same arguments and results as
    ``mlstm_recurrent`` from a zero state, the carry's m starting at
    -1e30.  Works in (chunk, B, H, step, D) order, so that each product
    is one batched matrix product."""
    B, S, H, D = q.shape
    c = min(chunk, S)
    while S % c:
        c //= 2
    N = S // c
    scale = D ** -0.5

    def chunks(x):            # (B, S, H, ...) -> (N, B, H, c, ...) float32
        x = x.reshape(B, N, c, H, *x.shape[3:]).transpose(2, 3)
        return x.transpose(0, 1).contiguous().float()

    qc, kc, vc = chunks(q) * scale, chunks(k), chunks(v)
    lf, li = chunks(log_f), chunks(log_i)
    # cumulative log forget within each chunk: F[t] = sum_{u<=t} lf[u]
    Fc = torch.cumsum(lf, -1)                               # (N, B, H, c)
    Ftot = Fc[..., -1]                                      # (N, B, H)
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.zeros((B, H, D, D), **f32)
    n = torch.zeros((B, H, D), **f32)
    m = torch.full((B, H), _M_INIT, **f32)
    outs = []
    for i in range(N):
        qb, kb, vb, ib, Fb, Ft = qc[i], kc[i], vc[i], li[i], Fc[i], Ftot[i]
        # source term s[j] = li[j] - F[j]; intra weight for j <= t is
        # exp(F[t] + s[j] - m_t); inter (carry) weight exp(F[t] + m - m_t)
        s_src = ib - Fb                                     # (B, H, c)
        # per-position stabilizer (the sequential recursion's m_t)
        m_t = torch.maximum(Fb + m[..., None], Fb + _cummax(s_src))
        logits = Fb[..., :, None] - Fb[..., None, :] + ib[..., None, :]
        logits = torch.where(tri, logits, -torch.inf)       # (B, H, t, j)
        w = torch.exp(logits - m_t[..., None])
        aw = (qb @ kb.transpose(-1, -2)) * w
        num_intra = aw @ vb                                 # (B, H, c, D)
        den_intra = torch.sum(aw, -1)
        inter_w = torch.exp(Fb + m[..., None] - m_t)        # (B, H, c)
        num_inter = (qb @ C) * inter_w[..., None]
        den_inter = (qb @ n[..., None])[..., 0] * inter_w
        num = num_intra + num_inter
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_t)) + eps
        outs.append(num / den[..., None])
        # carry update to the chunk's end
        m_next = torch.maximum(Ft + m, Ft + torch.amax(s_src, -1))
        wC = torch.exp(Ft[..., None] + s_src - m_next[..., None])
        decay = torch.exp(Ft + m - m_next)
        C = decay[..., None, None] * C \
            + kb.transpose(-1, -2) @ (wC[..., None] * vb)
        n = decay[..., None] * n + torch.sum(wC[..., None] * kb, -2)
        m = m_next
    out = torch.stack(outs, 1).transpose(2, 3).reshape(B, S, H, D)
    return out.to(q.dtype), (C, n, m)


def _mlstm_gates(p, h, dt):
    """Log-space forget and input gates per head from h (B, S, inner):
    products in the compute dtype, the biases cast to it before the add,
    then float32."""
    li = (h @ p["w_i"].to(dt) + p["b_i"].to(dt)).float()
    lf_pre = (h @ p["w_f"].to(dt) + p["b_f"].to(dt)).float()
    return F.logsigmoid(lf_pre), li


def mlstm_layer(cfg, p, x, *, positions=None, cache=None, mode="train",
                window=0, at=None):
    """The mLSTM block: x + down(cell(q, k, v) * silu(gate branch)).
    ``mode`` "train" (no cache), "prefill" (the chunkwise form; its final
    state goes into ``cache`` when one is given) or "decode" (S == 1, the
    step form from the cache's state)."""
    B, S, d = x.shape
    dt = cdt(cfg)
    H = cfg.n_heads
    inner = 2 * d
    hd = inner // H
    h_in = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    hv = h_in @ p["up_v"].to(dt)
    hg = h_in @ p["up_g"].to(dt)
    # block-diagonal per-head projections: (H, B*S, hd) @ (H, hd, hd)
    hvh = hv.reshape(B * S, H, hd).transpose(0, 1)
    q, k, v = ((hvh @ p[name].to(dt)).transpose(0, 1).reshape(B, S, H, hd)
               for name in ("wq", "wk", "wv"))
    log_f, log_i = _mlstm_gates(p, hv, dt)
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("mLSTM decode takes one step against a cache")
        out, (C, n, m) = mlstm_recurrent(q, k, v, log_f, log_i,
                                         c0=cache["C"], n0=cache["n"],
                                         m0=cache["m"])
    else:
        out, (C, n, m) = mlstm_chunkwise_parallel(q, k, v, log_f, log_i,
                                                  chunk=cfg.mlstm_chunk)
    if cache is not None and mode in ("prefill", "decode"):
        cache.update(C=C, n=n, m=m, pos=cache["pos"] + S)
    out = out.reshape(B, S, inner) * F.silu(hg)
    return x + out.to(dt) @ p["down"].to(dt), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_cache(cfg, batch, *, device):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d), **f32),
            "c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), _M_INIT, **f32), "pos": 0}


def _slstm_cell(x_t, state):
    """One sLSTM step with exponential gating and the stabilizer.  x_t:
    (B, 4d) float32 input pre-activations; state (h, c, n, m, w_rec,
    bias), the recurrence reading h.  Returns (h, c, n, m)."""
    h, c, n, m, w_rec, bias = state
    pre = torch.addmm(x_t, h, w_rec) + bias                 # x + h W + b
    z, i_pre, f_pre, o_pre = pre.chunk(4, -1)
    lf_m = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(lf_m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(lf_m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def slstm_scan(pre, w_rec, bias, state):
    """The sLSTM over pre (B, S, 4d) float32 from state (h, c, n, m), one
    step at a time.  Returns (hs (B, S, d), the final state)."""
    h, c, n, m = state
    hs = []
    for t in range(pre.shape[1]):
        h, c, n, m = _slstm_cell(pre[:, t], (h, c, n, m, w_rec, bias))
        hs.append(h)
    return torch.stack(hs, 1), (h, c, n, m)


def slstm_layer(cfg, p, x, *, positions=None, cache=None, mode="train",
                window=0, at=None):
    """The sLSTM block: x + down(scan(x W_in)).  The scan, ``w_rec`` and
    ``bias`` are float32.  Only decode starts from the cache's state (a
    prefill starts from zeros, as ``repro``'s does); prefill and decode
    store the final state when a cache is given."""
    B, S, d = x.shape
    dt = cdt(cfg)
    h_in = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    pre = (h_in @ p["w_in"].to(dt)).float()
    if cache is not None and mode == "decode":
        state = (cache["h"], cache["c"], cache["n"], cache["m"])
    else:
        zeros = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros, torch.full_like(zeros, _M_INIT))
    hs, (h, c, n, m) = slstm_scan(pre, p["w_rec"].float(),
                                  p["bias"].float(), state)
    if cache is not None and mode in ("prefill", "decode"):
        cache.update(h=h, c=c, n=n, m=m, pos=cache["pos"] + S)
    return x + hs.to(dt) @ p["down"].to(dt), cache
