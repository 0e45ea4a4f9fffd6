"""AdamW with global-norm clipping and a warmup + cosine schedule.

Port of ``repro.optim.adamw``, in the same order of operations: clip by the
global norm, update the moments, correct their bias, then
``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``, all in float32 (not
``torch.optim.AdamW``, whose decoupled decay multiplies ``p`` by
``1 - lr * wd`` first and rounds differently).  The state mirrors the
parameters as dictionaries keyed by parameter name.  Where ``repro``
returns new arrays, :func:`adamw_update` writes the parameters and the
moments in place and returns them, so a step holds no second copy.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d: updates taken
    mu: dict                    # name -> float32 first moment
    nu: dict                    # name -> float32 second moment


def adamw_init(params: dict) -> AdamWState:
    """Zero moments for ``params`` ({name: tensor}), on their devices."""
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu={n: zeros(p) for n, p in params.items()},
                      nu={n: zeros(p) for n, p in params.items()})


def global_norm(tensors):
    """sqrt of the sum of squares of every element, in float32: each
    leaf's norm in one batched pass (``torch._foreach_norm``), then the
    norm of those norms."""
    norms = torch._foreach_norm([x.float() for x in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def cosine_schedule(step, *, base_lr, warmup_steps, total_steps,
                    min_ratio=0.1):
    """Linear warmup, then a cosine from ``base_lr`` to ``min_ratio`` of it;
    ``step`` is the 0-d int32 count of updates taken (1-indexed inside, so
    the first update is small but not zero)."""
    step = step.float() + 1.0
    warm = step / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return base_lr * torch.where(step < warmup_steps, warm, cos)


# the elements of one batch of leaves: AdamW updates a batch's leaves
# together (``torch._foreach_*``, a few launches a pass for the batch, not a
# few a leaf), its temporaries at most two batches' size; a larger leaf is
# a batch of its own
GROUP = 1 << 26


def _batches(names, params):
    """``names`` in order, cut into runs of leaves of one dtype and device
    whose elements sum to at most :data:`GROUP` (a larger leaf alone)."""
    out, run, size, key = [], [], 0, None
    for n in names:
        p = params[n]
        k = (p.dtype, p.device)
        if run and (k != key or size + p.numel() > GROUP):
            out.append(run)
            run, size = [], 0
        run.append(n)
        size += p.numel()
        key = k
    return out + [run] if run else out


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, *,
                 learning_rate, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0):
    """One AdamW update of ``params`` by ``grads`` (both {name: tensor}).
    Returns ``(params, new_state, {"grad_norm", "lr"})``; the parameters
    and moments are updated in place.  Each element takes the same
    float32 operations in the same order as a leaf-by-leaf loop would,
    so batching the leaves changes no bit."""
    gnorm = global_norm(grads[n] for n in params)
    if grad_clip:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    step = state.step + 1
    b1c = 1.0 - beta1 ** step.float()
    b2c = 1.0 - beta2 ** step.float()
    for run in _batches(list(params), params):
        ps = [params[n] for n in run]
        pf = [p.float() for p in ps]
        ms = [state.mu[n] for n in run]
        vs = [state.nu[n] for n in run]
        g = torch._foreach_mul([grads[n].float() for n in run], scale)
        # m = beta1 m + (1 - beta1) g
        t = torch._foreach_mul(g, 1 - beta1)
        torch._foreach_mul_(ms, beta1)
        torch._foreach_add_(ms, t)
        del t
        # v = beta2 v + (1 - beta2) g g
        t = torch._foreach_mul(g, 1 - beta2)
        torch._foreach_mul_(t, g)
        del g
        torch._foreach_mul_(vs, beta2)
        torch._foreach_add_(vs, t)
        del t
        # delta = mhat / (sqrt(vhat) + eps) + wd p
        t = torch._foreach_div(vs, b2c)
        torch._foreach_sqrt_(t)
        torch._foreach_add_(t, eps)
        delta = torch._foreach_div(ms, b1c)
        torch._foreach_div_(delta, t)
        del t
        t = torch._foreach_mul(pf, weight_decay)
        torch._foreach_add_(delta, t)
        del t
        # p = p - lr delta
        torch._foreach_mul_(delta, learning_rate)
        torch._foreach_sub_(pf, delta)
        del delta
        if pf[0] is not ps[0]:
            torch._foreach_copy_(ps, pf)
    lr = torch.as_tensor(learning_rate, dtype=torch.float32,
                         device=gnorm.device)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
