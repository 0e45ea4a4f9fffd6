"""Training rows of packed text.  A mix that names this generator
(``"generator": "packed_text"``) gives ``batch`` rows of ``seq_len``
tokens a step: documents packed end to end into rows of the model's
pretraining length, as a pretraining job feeds them, with no mask at
the documents' boundaries (the program has none), so where they fall
changes none of the work.  Token ids are drawn uniformly over the
vocabulary, a step's rows anew from a generator of their own
(``draw.derive``), and each row's labels are its tokens shifted by one.
"""
from __future__ import annotations

import torch

from perfbench.harness import draw


class Feed:
    """``batch(i)``: step i's batch, the same for the program and the
    reference (tokens and labels (B, S), int64)."""

    def __init__(self, traffic: dict, dm, seed: int, device):
        self.seed, self.device, self.vocab = seed, device, dm.vocab
        self.B, self.S = traffic["batch"], traffic["seq_len"]
        self.tokens_per_step = self.B * self.S

    def batch(self, i: int) -> dict:
        g = draw.generator(self.device, self.seed, "train", i)
        rows = torch.randint(0, self.vocab, (self.B, self.S + 1),
                             generator=g, device=self.device)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    reference_batch = batch
