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
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


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


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, *,
                 learning_rate, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0):
    """One AdamW update of ``params`` by ``grads`` (both {name: tensor}).
    Returns ``(params, new_state, {"grad_norm", "lr"})``; the parameters
    and moments are updated in place."""
    gnorm = global_norm(grads[n] for n in params)
    if grad_clip:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    step = state.step + 1
    b1c = 1.0 - beta1 ** step.float()
    b2c = 1.0 - beta2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state.mu[name], state.nu[name]
        m.copy_(beta1 * m + (1 - beta1) * g)
        v.copy_(beta2 * v + (1 - beta2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_((p.float() - learning_rate * delta).to(p.dtype))
    lr = torch.as_tensor(learning_rate, dtype=torch.float32,
                         device=gnorm.device)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
