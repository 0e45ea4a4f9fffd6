"""Faults planted in the program under test, each a context manager that
patches the port's modules for the time of one run, to show that the
numbers deciding ``correct`` catch them.

train: ``state_unchanged`` (the step computes its gradients but leaves the
parameters and AdamW's state as they were), ``half_batch`` (the loss, and
so the gradients, taken as the mean over the first half of the rows).
serve: ``state_unchanged`` (the prefill leaves the cache as it was
given), ``half_batch`` (the prefill runs the first half of the requests
and hands their cache and tokens to the other half too),
``token_altered`` (each decode step serves the token after its argmax).
"""
from __future__ import annotations

import contextlib

import torch


def _port():
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    return steps, transformer


def _half(batch: dict) -> dict:
    h = batch["labels"].shape[0] // 2
    return {k: v[:h] for k, v in batch.items()}


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def train_state_unchanged():
    steps, _ = _port()

    def update(grads, state, params, **kw):
        from repro_torch.optim import global_norm
        gnorm = global_norm(grads.values())
        return params, state, {"grad_norm": gnorm,
                               "lr": torch.zeros_like(gnorm)}

    return patched(steps, "adamw_update", update)


def train_half_batch():
    _, transformer = _port()
    loss = transformer.lm_loss
    return patched(transformer, "lm_loss", lambda m, b: loss(m, _half(b)))


def serve_state_unchanged():
    """The prefill leaves the cache as it was given: fresh, its slots zero
    and its positions at the start.  (Zeroed in place after the prefill,
    so the fault holds no second cache on a card that is nearly full.)"""
    steps, _ = _port()
    make = steps.make_prefill_step

    def make_prefill(cfg):
        prefill = make(cfg)

        def run(model, cache, batch):
            logits, cache = prefill(model, cache, batch)
            for layer in cache["layers"]:
                layer["k"].zero_()
                layer["v"].zero_()
                layer["pos"] = 0
            cache["t"] = 0
            return logits, cache

        return run

    return patched(steps, "make_prefill_step", make_prefill)


def serve_half_batch():
    """The prefill runs the first half of the requests, into those rows of
    the cache, and hands their cache rows and tokens to the other half."""
    steps, _ = _port()
    make = steps.make_prefill_step

    def make_prefill(cfg):
        prefill = make(cfg)

        def run(model, cache, batch):
            B = batch["tokens"].shape[0]
            h = max(B // 2, 1)
            sub = {"layers": [dict(l, k=l["k"][:h], v=l["v"][:h])
                              for l in cache["layers"]], "t": cache["t"]}
            logits, sub = prefill(model, sub, {k: v[:h] for k, v in
                                               batch.items()})
            for mine, theirs in zip(cache["layers"], sub["layers"]):
                for i in range(h, B):
                    mine["k"][i].copy_(mine["k"][i % h])
                    mine["v"][i].copy_(mine["v"][i % h])
                mine["pos"] = theirs["pos"]
            cache["t"] = sub["t"]
            rows = torch.arange(B, device=logits.device) % h
            return logits[rows], cache

        return run

    return patched(steps, "make_prefill_step", make_prefill)


def serve_token_altered():
    steps, _ = _port()
    make = steps.make_decode_step

    def make_decode(cfg):
        decode = make(cfg)

        def run(model, cache, batch):
            logits, tok, cache = decode(model, cache, batch)
            return logits, (tok + 1) % cfg.vocab_size, cache

        return run

    return patched(steps, "make_decode_step", make_decode)


FAULTS = {
    "train": {"state_unchanged": train_state_unchanged,
              "half_batch": train_half_batch},
    "serve": {"state_unchanged": serve_state_unchanged,
              "half_batch": serve_half_batch,
              "token_altered": serve_token_altered},
}
