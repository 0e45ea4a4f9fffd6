"""Step builders of the serving path: prefill and greedy decode.

Counterpart of ``make_prefill_step`` / ``make_decode_step`` in
``repro.launch.steps``.  A step takes (model, cache, batch) where JAX's
takes (params, cache, batch); the cache is updated in place and returned.
The train step is not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch


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
