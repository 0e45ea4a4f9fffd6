"""Deterministic, shardable synthetic LM data pipeline.

Port of ``repro.data.pipeline.SyntheticLM``, with the same contract:
  * **step-addressable** - ``batch(step)`` is a pure function of (seed,
    step, replica), so a job resumed from checkpoint step k regenerates
    exactly the batches it would have seen (no data-loader state to
    checkpoint);
  * **elastic** - the global batch is carved by (replica_id, n_replicas);
  * **structured** - tokens follow the same Zipfian marginal (exponent
    ``zipf_alpha``) with the same Markov copy mask (the second half of
    every ``markov_period`` repeats the token half a period back), and
    labels are the tokens shifted by one, so the loss falls.

The draws are not ``repro``'s: it samples with ``jax.random.categorical``,
whose bits PyTorch cannot reproduce.  Here a CPU ``torch.Generator``
seeded from (seed, step, replica) draws float64 uniforms that invert the
Zipf CDF, so a batch is the same on every device; it is then moved to
``device``.  Every test that compares numbers with ``repro`` feeds
``repro``'s batches, as numpy, to both sides.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    markov_period: int = 16
    device: str = "cuda"

    def _cdf(self) -> torch.Tensor:
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_alpha)
        return torch.as_tensor(np.cumsum(p / p.sum()))

    def _generator(self, step: int, replica_id: int) -> torch.Generator:
        words = np.random.SeedSequence(
            [self.seed, step, replica_id]).generate_state(2, np.uint32)
        return torch.Generator().manual_seed(
            (int(words[0]) << 31) ^ int(words[1]))

    def batch(self, step: int, replica_id: int = 0, n_replicas: int = 1):
        """Returns {tokens, labels (int32), mask (float32)}, each
        (global_batch / n_replicas, seq_len), for this replica's slice of
        the global batch at ``step``; fully deterministic."""
        if self.global_batch % n_replicas:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {n_replicas} replicas")
        dev = resolve_device(self.device)
        local = self.global_batch // n_replicas
        u = torch.rand((local, self.seq_len + 1), dtype=torch.float64,
                       generator=self._generator(step, replica_id))
        draw = torch.clamp(torch.searchsorted(self._cdf(), u, right=True),
                           max=self.vocab_size - 1)
        # Markov mixing: periodically repeat earlier tokens so there is
        # learnable structure; the copy source sits in the unreplaced half
        # of the previous half-period, so targets equal an observed token
        idx = torch.arange(self.seq_len + 1)
        src = torch.clamp(idx - self.markov_period // 2, min=0)
        repeat = (idx % self.markov_period) >= (self.markov_period // 2)
        seq = torch.where(repeat[None, :], draw[:, src], draw).to(torch.int32)
        tokens, labels = seq[:, :-1], seq[:, 1:]
        return {"tokens": tokens.contiguous().to(dev),
                "labels": labels.contiguous().to(dev),
                "mask": torch.ones(labels.shape, dtype=torch.float32,
                                   device=dev)}
