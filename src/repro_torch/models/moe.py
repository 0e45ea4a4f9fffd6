"""Mixture-of-Experts block: the top-k router, capacity-bounded dispatch
into per-expert buffers, the experts, and the combine.

Counterpart of ``repro.models.moe`` (moonshot-v1-16b-a3b: 64 experts,
top-6; phi3.5-moe-42b-a6.6b: 16 experts, top-2), with its names and what
it computes:

- Tokens are grouped over the flattened B * S, in groups of
  ``_group_size(T)``.  A group can span sequences, so one token's routing
  depends on its neighbours through capacity drops.
- The router logits come out of a product in the compute dtype and are
  cast to float32 after it (in bf16 they are rounded to bf16 first), then
  a float32 softmax.
- Each token's top K come from a stable descending sort: among equal
  probabilities the lower expert index comes first, the order
  ``jax.lax.top_k`` gives ties (``torch.topk`` promises none).  Ties are to
  be expected: bf16-rounded logits have 8 significant bits.
- The gates are renormalised by max(sum, 1e-9) in float32, the sum taken k
  by k, the order in which XLA sums these few terms.
- ``capacity = max(int(capacity_factor * Tg * K / E), 4)``.  A (token, k)
  pair's slot in its expert's buffer counts the group's earlier pairs of
  that expert, token-major and k-minor; the pair is kept while its slot is
  below the capacity, else dropped (slot -1).
- The experts run on every slot of their buffers, empty ones as zeros.

``repro`` dispatches and combines by one-hot einsums, which GSPMD can
shard.  The port gathers by index, with the same values: the dispatch
einsum sums one ``x * 1.0`` and zeros for each slot, and the combine at
most K float32 products a token (here in k order, so the sum agrees within
float32 rounding).  At moonshot's full size the einsums would cost more
than the experts they feed.  Dispatch and combine are autograd Functions
whose backwards are gathers again: autograd of advanced indexing
accumulates with atomics on CUDA, whose order varies from run to run.

The slots are laid out (E, G, C): one expert's buffers are contiguous, so
the expert products are one batched matrix product over E.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import attention_block, cdt, rms_norm

MOE_GROUP = 512  # tokens per dispatch group


def _group_size(T: int) -> int:
    g = min(MOE_GROUP, T)
    while T % g:
        g //= 2
    return max(g, 1)


@dataclasses.dataclass
class Routing:
    """One call's routing of (G, Tg) tokens: ``gate`` (G, Tg, K) float32
    renormalised gates, ``idx`` (G, Tg, K) int64 experts, ``slot`` (G, Tg,
    K) int64 position in the expert's buffer of the group, -1 where the
    pair is dropped, and the buffers' ``capacity``."""
    gate: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    capacity: int


def router_probs(cfg, router, xt):
    """Float32 softmax of the router logits of ``xt`` (..., d), the product
    taken in the compute dtype."""
    logits = (xt @ router.to(cdt(cfg))).float()
    return torch.softmax(logits, dim=-1)


def route(cfg, probs) -> Routing:
    """Top-k routing and capacity slots from ``probs`` (G, Tg, E)."""
    G, Tg, E = probs.shape
    K = cfg.top_k
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :K]
    vals = torch.gather(probs, -1, idx)
    total = vals[..., 0]
    for k in range(1, K):
        total = total + vals[..., k]
    gate = vals / torch.clamp(total, min=1e-9)[..., None]
    capacity = max(int(cfg.capacity_factor * Tg * K / E), 4)
    pairs = idx.reshape(G, Tg * K, 1)
    # an integer count, exact where repro's float32 cumsum is (below 2^24)
    count = torch.cumsum(F.one_hot(pairs[..., 0], E), dim=1)
    pos = torch.gather(count, -1, pairs)[..., 0].view(G, Tg, K) - 1
    slot = torch.where(pos < capacity, pos, -1)
    return Routing(gate, idx, slot, capacity)


def _index_maps(r: Routing, E: int):
    """``pair_slot`` (T * K,): each pair's flat slot in the (E, G, C)
    buffers, or E * G * C (one past them) when dropped; ``slot_pair``
    (E * G * C,): each slot's pair index t * K + k, or T * K when
    empty."""
    G, Tg, K = r.idx.shape
    C = r.capacity
    n_slots, n_pairs = E * G * C, G * Tg * K
    group = torch.arange(G, device=r.idx.device)[:, None, None]
    flat = (r.idx * G + group) * C + r.slot
    pair_slot = torch.where(r.slot >= 0, flat, n_slots).reshape(-1)
    slot_pair = torch.full((n_slots + 1,), n_pairs, dtype=torch.int64,
                           device=r.idx.device)
    # kept pairs own distinct slots; the dropped ones all write the extra
    # entry, which is cut off
    slot_pair[pair_slot] = torch.arange(n_pairs, device=r.idx.device)
    return pair_slot, slot_pair[:n_slots]


def _wide(t):
    """``t`` in float32, or float64 if it is: the dtype the sums run in."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _clamped(index, end):
    """``index`` with the entries past its buffer (``>= end``) pointed at
    row 0, and the mask of those that were not."""
    valid = index < end
    return torch.where(valid, index, 0), valid


class Dispatch(torch.autograd.Function):
    """``xe[s] = x[token of slot s]``, zeros for an empty slot.  Backward:
    ``dx[t]`` sums ``dxe`` over the token's kept slots in k order, in
    float32, rounded once to x's dtype (``repro``'s dispatch is a float32
    einsum cast to the compute dtype).

    The empty slots read a zero row appended to ``x``: x has T rows, the
    buffers about 1.25 K T, so that copy costs less than zeroing the
    buffers' empty rows after the gather."""

    @staticmethod
    def forward(ctx, x, pair_slot, slot_pair, K):
        ctx.save_for_backward(pair_slot)
        ctx.K = K
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[slot_pair // K]

    @staticmethod
    def backward(ctx, dxe):
        pair_slot, = ctx.saved_tensors
        ps, kept = _clamped(pair_slot.view(-1, ctx.K), dxe.shape[0])
        # a dropped pair reads row 0 times 0 (exact: dxe is finite)
        keep = kept.to(torch.promote_types(dxe.dtype, torch.float32))
        dx = dxe[ps[:, 0]] * keep[:, :1]
        for k in range(1, ctx.K):
            dx = torch.addcmul(dx, dxe[ps[:, k]], keep[:, k, None])
        return dx.to(dxe.dtype), None, None, None


class Combine(torch.autograd.Function):
    """``y[t] = sum_k w[t, k] ye[slot(t, k)]`` over the token's kept pairs,
    in k order, in float32, rounded once to ``dtype``.  Backward:
    ``dye[s] = w[pair] dy[token]`` for the pair owning slot s (zeros for an
    empty one), rounded to ye's dtype, and ``dw[t, k] = <dy[t],
    ye[slot(t, k)]>`` in float32 (zero for a dropped pair).  A dropped
    pair (an empty slot) reads row 0 with a weight of 0, so no buffer is
    copied: as in ``repro``'s one-hot einsums, a non-finite expert output
    would reach every token of its group."""

    @staticmethod
    def forward(ctx, ye, w, pair_slot, slot_pair, dtype):
        K = w.shape[1]
        ps, kept = _clamped(pair_slot.view(-1, K), ye.shape[0])
        wk = torch.where(kept, w, 0)
        # float32 (or float64) products: the weights promote ye's rows
        y = wk[:, 0, None] * ye[ps[:, 0]]
        for k in range(1, K):
            y = y + wk[:, k, None] * ye[ps[:, k]]
        ctx.save_for_backward(ye, w, pair_slot, slot_pair)
        return y.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        ye, w, pair_slot, slot_pair = ctx.saved_tensors
        K = w.shape[1]
        dyf = _wide(dy)
        sp, filled = _clamped(slot_pair, w.numel())
        ws = torch.where(filled, w.reshape(-1)[sp], 0)
        dye = (ws[:, None] * dyf[sp // K]).to(ye.dtype)
        ps, kept = _clamped(pair_slot.view(-1, K), ye.shape[0])
        dw = torch.stack([(dyf * ye[ps[:, k]]).sum(-1)
                          for k in range(K)], dim=-1)
        return dye, torch.where(kept, dw, 0), None, None, None


def moe_mlp(cfg, p, x):
    """x: (B, S, d) -> (B, S, d) with top-k expert routing.  ``p``:
    ``router`` (d, E), ``gate`` and ``up`` (E, d, f), ``down`` (E, f, d),
    each cast to the compute dtype at use."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = cdt(cfg)
    T = B * S
    Tg = _group_size(T)
    G = T // Tg
    r = route(cfg, router_probs(cfg, p["router"], x.reshape(G, Tg, d)))
    pair_slot, slot_pair = _index_maps(r, E)
    xe = Dispatch.apply(x.reshape(T, d), pair_slot, slot_pair, K).to(dt)
    xe = xe.view(E, G * r.capacity, d)
    g = torch.bmm(xe, p["gate"].to(dt))
    u = torch.bmm(xe, p["up"].to(dt))
    ye = torch.bmm(F.silu(g) * u, p["down"].to(dt))        # (E, G * C, d)
    y = Combine.apply(ye.view(-1, d), r.gate.reshape(T, K), pair_slot,
                      slot_pair, x.dtype)
    return y.view(B, S, d)


def aux_load_balance_loss(cfg, x, p):
    """Switch-style load-balance auxiliary (fraction * router prob per
    expert).  ``lm_loss`` does not add it, as in ``repro``."""
    T = x.shape[0] * x.shape[1]
    probs = router_probs(cfg, p["router"], x).reshape(T, -1)
    top1 = torch.argmax(probs, dim=-1)      # the first of equal maxima
    frac = F.one_hot(top1, cfg.n_experts).float().mean(0)
    return cfg.n_experts * torch.sum(frac * probs.mean(0))


def moe_layer(cfg, p, x, *, positions, cache=None, mode="train", window=0,
              at=None):
    h, cache = attention_block(cfg, p["attn"],
                               rms_norm(x, p["ln1"]["scale"], cfg.norm_eps),
                               positions=positions, cache=cache, mode=mode,
                               window=window, at=at)
    x = x + h
    x = x + moe_mlp(cfg, p["moe"],
                    rms_norm(x, p["ln2"]["scale"], cfg.norm_eps))
    return x, cache
