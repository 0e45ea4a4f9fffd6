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

from ..models import transformer as T
from ..optim import adamw_update, cosine_schedule


def make_train_step(cfg, tc):
    """The train step of ``tc`` (a ``TrainConfig``): ``lm_loss`` and its
    gradients, over ``tc.grad_accum`` microbatches (consecutive slices of
    the batch, gradients summed in float32 and divided by their count,
    the losses averaged), then the cosine learning rate and AdamW."""
    accum = max(int(tc.grad_accum), 1)

    def value_and_grad(model, batch):
        params = list(model.parameters())
        loss, aux = T.lm_loss(model, batch)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def train_step(model, opt_state, batch):
        names = [n for n, _ in model.named_parameters()]
        if accum == 1:
            loss, aux, grads = value_and_grad(model, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum} microbatches")
            mb = B // accum
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in model.parameters()]
            losses, auxes = [], []
            for i in range(accum):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, aux_i, g = value_and_grad(model, part)
                acc = [a + gi.float() for a, gi in zip(acc, g)]
                losses.append(loss_i)
                auxes.append(aux_i)
            grads = [a / accum for a in acc]
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([a[k] for a in auxes]).mean()
                   for k in auxes[0]}
        lr = cosine_schedule(opt_state.step, base_lr=tc.learning_rate,
                             warmup_steps=tc.warmup_steps,
                             total_steps=tc.total_steps)
        _, opt_state, om = adamw_update(
            dict(zip(names, grads)), opt_state, dict(model.named_parameters()),
            learning_rate=lr, beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
            weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
        return model, opt_state, {"loss": loss, **aux, **om}

    return train_step


def make_prefill_step(cfg):
    def prefill(model, cache, batch):
        return model.prefill_step(batch["tokens"], cache)

    return prefill


def make_decode_step(cfg):
    def decode(model, cache, batch):
        logits, cache = model.decode_step(batch["tokens"], cache)
        # greedy next token inside the step, as repro keeps it in-graph
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return logits, next_tok, cache

    return decode
