"""Serving traffic in batches of one prompt length.  A mix that names
this generator (``"generator": "length_grouped"``) states a distribution
of prompt lengths and one of answer lengths (each a lognormal by its
median and ``sigma``, clipped to ``[min, max]``) and a batch size.

An offline job over a large queue groups its requests by prompt length,
since the program's server takes a (B, S) batch of one length, and
decodes each batch until its longest answer is done.  So that every seed
does the same work, the sizes are fixed by the mix and not by the seed:
a cycle of ``batches`` batches takes its prompt lengths at the
distribution's quantiles (k + 1/2) / batches, in bit-reversed order (so
each block of a power of two batches spans the distribution), and its
``batches x batch`` answer lengths at the answer distribution's
quantiles, dealt to the batches by a shuffle fixed by ``deal_seed``.
The seed draws the prompts' token ids, a batch's from a generator of its
own (``draw.derive``); the cycle repeats with new ids.
"""
from __future__ import annotations

import math
import random
import statistics

import torch

from perfbench.harness import draw


def quantiles(dist: dict, n: int) -> list[int]:
    """The n lengths at quantiles (k + 1/2) / n of ``dist``."""
    z = statistics.NormalDist()
    out = []
    for k in range(n):
        x = dist["median"] * math.exp(dist["sigma"]
                                      * z.inv_cdf((k + 0.5) / n))
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return out


def bit_reversed(n: int) -> list[int]:
    bits = n.bit_length() - 1
    if n != 1 << bits:
        raise ValueError(f"batches a cycle ({n}) must be a power of two")
    return [int(format(k, f"0{bits}b")[::-1] or "0", 2) for k in range(n)]


def plan(traffic: dict) -> list[tuple[int, list[int]]]:
    """(prompt length, the batch's answer lengths) of each batch of one
    cycle, in the order they are served."""
    n, B = traffic["batches"], traffic["batch"]
    prompts = quantiles(traffic["prompt"], n)
    answers = quantiles(traffic["answer"], n * B)
    random.Random(traffic["deal_seed"]).shuffle(answers)
    return [(prompts[k], answers[k * B:(k + 1) * B])
            for k in bit_reversed(n)]


class Feed:
    """``shape(b)``: batch b's prompt length and answer lengths;
    ``batch(b)``: its prefill inputs (token ids (B, S)); ``request(b, r,
    served)``: request r's prompt and its first len(served) - 1 served
    tokens, the ids a full forward of the reference reads."""

    def __init__(self, traffic: dict, dm, seed: int, device):
        self.seed, self.device, self.vocab = seed, device, dm.vocab
        self.B = traffic["batch"]
        self.block = traffic["block"]
        self.plan = plan(traffic)

    def shape(self, b: int) -> tuple[int, list[int]]:
        return self.plan[b % len(self.plan)]

    def batch(self, b: int) -> dict:
        S, _ = self.shape(b)
        g = draw.generator(self.device, self.seed, "serve", b)
        tokens = torch.randint(0, self.vocab, (self.B, S), generator=g,
                               device=self.device)
        return {"tokens": tokens}

    def request(self, b: int, r: int, served):
        prompt = self.batch(b)["tokens"][r]
        fed = torch.as_tensor(list(served[:-1]), dtype=prompt.dtype,
                              device=prompt.device)
        return torch.cat([prompt, fed])
