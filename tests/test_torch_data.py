"""The port's synthetic LM pipeline (``repro_torch.data.SyntheticLM``) on
the CPU: the four properties ``tests/test_data.py`` holds ``repro``'s to
(step-addressable determinism, labels shifted by one, replica slices,
learnable copy structure), and the same Zipf marginal as ``repro``'s.

The draws themselves differ from ``repro``'s (a torch.Generator cannot
give ``jax.random.categorical``'s bits), so the marginal is compared in
distribution: the rank-1 token's frequency and the share of the 16 most
frequent tokens over 64 x 512 draws, within 0.01 of the exact Zipf
probabilities that both pipelines sample.
"""
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import SyntheticLM


def _pipe(**kw):
    return SyntheticLM(device="cpu", **kw)


def test_step_addressable_determinism():
    p = _pipe(vocab_size=128, seq_len=16, global_batch=8, seed=3)
    b1, b2 = p.batch(12), p.batch(12)
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    assert not torch.equal(b1["tokens"], p.batch(13)["tokens"])
    assert not torch.equal(
        b1["tokens"], _pipe(vocab_size=128, seq_len=16, global_batch=8,
                            seed=4).batch(12)["tokens"])


def test_labels_are_shifted_tokens():
    b = _pipe(vocab_size=128, seq_len=16, global_batch=4, seed=0).batch(0)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert b["mask"].dtype == torch.float32 and bool((b["mask"] == 1).all())
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_replica_slices_partition_global_batch():
    p = _pipe(vocab_size=128, seq_len=8, global_batch=8, seed=1)
    assert p.batch(5, 0, 1)["tokens"].shape == (8, 8)
    halves = [p.batch(5, r, 2)["tokens"] for r in (0, 1)]
    assert halves[0].shape == (4, 8)
    assert not torch.equal(halves[0], halves[1])
    with pytest.raises(ValueError, match="split"):
        p.batch(5, 0, 3)


def test_learnable_structure():
    """The Markov copy structure makes labels partially predictable."""
    p = _pipe(vocab_size=1024, seq_len=64, global_batch=16, seed=2)
    toks = p.batch(0)["tokens"].numpy()
    period = p.markov_period
    idx = np.arange(toks.shape[1])
    rep = (idx % period) >= (period // 2)
    src = np.maximum(idx - period // 2, 0)
    assert (toks[:, rep] == toks[:, src[rep]]).mean() > 0.9


def test_zipf_marginal_matches_repro():
    V, B, S = 1000, 64, 512
    ranks = np.arange(1, V + 1, dtype=np.float64) ** -1.1
    probs = ranks / ranks.sum()
    period = 16
    # the unreplaced half of each period holds the raw draws
    raw = (np.arange(S + 1) % period) < period // 2
    for pipe in (_pipe(vocab_size=V, seq_len=S, global_batch=B, seed=0),
                 JSyntheticLM(vocab_size=V, seq_len=S, global_batch=B,
                              seed=0)):
        b = pipe.batch(0)
        seq = np.concatenate([np.asarray(b["tokens"]),
                              np.asarray(b["labels"])[:, -1:]], axis=1)
        draws = seq[:, raw].ravel()
        assert draws.min() >= 0 and draws.max() < V
        freq = np.bincount(draws, minlength=V) / draws.size
        assert abs(freq[0] - probs[0]) < 0.01
        assert abs(freq[:16].sum() - probs[:16].sum()) < 0.01


def test_batch_lands_on_the_pipeline_device():
    b = _pipe(vocab_size=64, seq_len=8, global_batch=2).batch(0)
    assert all(x.device == torch.device("cpu") for x in b.values())
