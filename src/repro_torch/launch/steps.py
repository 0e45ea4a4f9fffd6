"""Step builders: the train step (loss, gradients, AdamW), prefill and
greedy decode.

Counterpart of ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` in ``repro.launch.steps``.  A step takes the model
where JAX's takes its params: ``train_step(model, opt_state, batch)``
updates the model's parameters and the optimizer state in place and
returns them with the metrics; the serving steps update the cache in place
and return it.  The abstract specs and shardings of ``repro.launch.steps``
are XLA's and have no counterpart.
"""
from __future__ import annotations

import torch

from .. import sharding, tracing
from ..models import transformer as T
from ..optim import adamw_update, cosine_schedule


def value_and_grad(model, batch):
    """``lm_loss`` of ``batch``, its aux terms, and the gradient of every
    parameter in ``model.parameters()`` order.  A parameter the loss does
    not read (musicgen's untied embedding table under an embeds batch)
    gets zeros, as ``jax.value_and_grad`` gives it."""
    params = list(model.parameters())
    with tracing.span("step.forward", device=model.device):
        loss, aux = T.lm_loss(model, batch)
    # remat's recomputation of each layer runs inside the backward
    with tracing.span("step.backward", device=model.device):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _average_over_ranks(group, loss, aux, grads):
    """The loss, the aux terms and the gradients summed over the ranks of
    ``group`` and divided by its size, through one flat float32 buffer and
    one ``all_reduce`` a step."""
    world = torch.distributed.get_world_size(group)
    keys = list(aux)
    scalars = [loss, *(aux[k] for k in keys)]
    flat = torch.cat([torch.stack(scalars).float()]
                     + [g.reshape(-1).float() for g in grads])
    sharding.all_reduce_sum_(flat, group).div_(world)
    parts = flat.split([len(scalars)] + [g.numel() for g in grads])
    out = [p.view(g.shape) for p, g in zip(parts[1:], grads)]
    return parts[0][0], dict(zip(keys, parts[0][1:])), out


def make_train_step(cfg, tc, group=None):
    """The train step of ``tc`` (a ``TrainConfig``): ``lm_loss`` and its
    gradients, over ``tc.grad_accum`` microbatches (consecutive slices of
    the batch axis, which is axis 1 of (3, B, S) M-RoPE positions;
    gradients summed in float32 and divided by their count, the losses
    averaged), then the cosine learning rate and AdamW.

    Data parallelism, the counterpart of ``repro``'s gradient anchoring on
    its batch axes: with a ``torch.distributed`` ``group`` of W > 1 ranks,
    each rank's ``batch`` is its slice of the global batch; after its own
    gradients (accumulated, when ``grad_accum > 1``) the float32 gradients,
    the loss and the aux terms are summed over the ranks and divided by W,
    so that AdamW, the clip and ``grad_norm`` see the same values on every
    rank.  At W = 2 a step equals one process's step on the global batch
    with ``grad_accum = 2`` bit for bit (a + b rounds alike in either
    order); at larger W the sums' order differs.  Routing capacity and
    ``moe.aux_load_balance_loss`` are computed per rank's slice, so a MoE
    arch under data parallelism matches ``grad_accum = W``, not one
    process on the global batch."""
    accum = max(int(tc.grad_accum), 1)
    world = 1 if group is None else torch.distributed.get_world_size(group)

    def microbatch(batch, i, mb):
        def cut(k, v):
            if k == "positions" and v.ndim == 3:
                return v[:, i * mb:(i + 1) * mb]
            return v[i * mb:(i + 1) * mb]
        return {k: cut(k, v) for k, v in batch.items()}

    def update(model, opt_state, batch):
        names = [n for n, _ in model.named_parameters()]
        if accum == 1:
            loss, aux, grads = value_and_grad(model, batch)
        else:
            B = batch["labels"].shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum} microbatches")
            mb = B // accum
            # summed and divided in place (the same roundings as a + g and
            # a / accum), each microbatch's gradients dropped once summed:
            # no second float32 copy of the parameters' size is held
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in model.parameters()]
            losses, auxes = [], []
            for i in range(accum):
                loss_i, aux_i, g = value_and_grad(model,
                                                  microbatch(batch, i, mb))
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                del g
                losses.append(loss_i)
                auxes.append(aux_i)
            grads = [a.div_(accum) for a in acc]
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([a[k] for a in auxes]).mean()
                   for k in auxes[0]}
        if world > 1:
            loss, aux, grads = _average_over_ranks(group, loss, aux, grads)
        with tracing.span("step.optimizer", device=model.device):
            lr = cosine_schedule(opt_state.step, base_lr=tc.learning_rate,
                                 warmup_steps=tc.warmup_steps,
                                 total_steps=tc.total_steps)
            _, opt_state, om = adamw_update(
                dict(zip(names, grads)), opt_state,
                dict(model.named_parameters()), learning_rate=lr,
                beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
        return model, opt_state, {"loss": loss, **aux, **om}

    def train_step(model, opt_state, batch):
        with tracing.span("step.train", device=model.device,
                          tokens=batch["labels"].numel(), unit=True):
            return update(model, opt_state, batch)

    return train_step


def _positions(batch) -> int:
    """The (B, S) positions a serving batch feeds, tokens or embeds."""
    x = batch.get("tokens")
    return x.numel() if x is not None else batch["embeds"].shape[:2].numel()


def make_prefill_step(cfg):
    def prefill(model, cache, batch):
        # a batch's prefill opens its unit, which its decode steps join
        with tracing.span("step.prefill", device=model.device,
                          tokens=_positions(batch), unit=True):
            return model.prefill_step(batch.get("tokens"), cache,
                                      embeds=batch.get("embeds"),
                                      positions=batch.get("positions"))

    return prefill


def make_decode_step(cfg):
    def decode(model, cache, batch):
        # the host's issue of the step: nothing in it waits for the card
        with tracing.span("step.decode", device=model.device,
                          tokens=_positions(batch)):
            logits, cache = model.decode_step(
                batch.get("tokens"), cache, embeds=batch.get("embeds"),
                positions=batch.get("positions"))
            # greedy next token inside the step, as repro keeps it in-graph
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return logits, next_tok, cache

    return decode
