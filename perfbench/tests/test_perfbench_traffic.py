"""The generators: the same seed gives the same rows, another seed other
rows; the serving plan takes its sizes from the mix's distributions, the
same for every seed, and each block of it spans them."""
import json
import statistics

import pytest
import torch

import small
from perfbench.generators import length_grouped, packed_text
from perfbench.harness import cell, draw
from perfbench.reference.dense import Dims

CPU = torch.device("cpu")
SEEDS = (0, 3, 2 ** 31 + 11, 2 ** 40 + 5)


def _dims(name="yi-34b"):
    return Dims.from_file(small.config(name))


def _train(seed):
    return packed_text.Feed(small.traffic("pretrain-4k"), _dims("yi-34b-4l"),
                            seed, CPU)


def _serve(seed, mix=None):
    return length_grouped.Feed(mix or small.traffic("code-completion"),
                               _dims(), seed, CPU)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_rows_repeat_by_seed_and_differ_across(seed):
    a, b, c = _train(seed), _train(seed), _train(seed + 1)
    for i in range(3):
        x, y, z = a.batch(i), b.batch(i), c.batch(i)
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["labels"], y["labels"])
        assert not torch.equal(x["tokens"], z["tokens"])
    assert not torch.equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    x = a.batch(2)
    assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert x["tokens"].shape == (a.B, a.S) and int(x["tokens"].max()) < 96


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_requests_repeat_by_seed_and_differ_across(seed):
    a, b, c = _serve(seed), _serve(seed), _serve(seed + 1)
    x, y, z = a.batch(1), b.batch(1), c.batch(1)
    assert torch.equal(x["tokens"], y["tokens"])
    assert not torch.equal(x["tokens"], z["tokens"])
    assert x["tokens"].shape == (a.B, a.shape(1)[0])
    # the sizes are the mix's, not the seed's
    assert a.plan == c.plan


def test_serve_request_for_the_reference_is_the_programs_row():
    f = _serve(9)
    batch = f.batch(2)
    S = f.shape(2)[0]
    served = [5, 6, 7, 8]
    ids = f.request(2, 1, served)
    assert torch.equal(ids[:S], batch["tokens"][1])
    assert ids[S:].tolist() == [5, 6, 7]


def test_quantiles_follow_the_distribution():
    dist = {"median": 1500, "sigma": 0.7, "min": 64, "max": 10 ** 6}
    q = length_grouped.quantiles(dist, 64)
    assert q == sorted(q)
    assert statistics.median(q) == pytest.approx(1500, rel=0.02)
    clipped = length_grouped.quantiles({**dist, "max": 2000}, 64)
    assert max(clipped) == 2000 and min(clipped) >= 64


def test_bit_reversed_order():
    assert length_grouped.bit_reversed(8) == [0, 4, 2, 6, 1, 5, 3, 7]
    with pytest.raises(ValueError):
        length_grouped.bit_reversed(6)


def test_the_cell_s_plan():
    mix = json.loads((cell.BENCH / "traffic" /
                      "code-completion.json").read_text())
    plan = length_grouped.plan(mix)
    n, B = mix["batches"], mix["batch"]
    assert len(plan) == n and all(len(a) == B for _, a in plan)
    prompts = sorted(s for s, _ in plan)
    assert prompts == length_grouped.quantiles(mix["prompt"], n)
    answers = sorted(x for _, a in plan for x in a)
    assert answers == length_grouped.quantiles(mix["answer"], n * B)
    # every request fits the model's positions
    assert max(s for s, _ in plan) + mix["answer"]["max"] <= 4096
    # each block of the window spans the prompt distribution: one batch
    # from each quarter of it
    block = mix["block"]
    rank = {s: i for i, s in enumerate(prompts)}
    for k in range(0, n, block):
        quarters = {rank[s] * block // n for s, _ in plan[k:k + block]}
        assert quarters == set(range(block))


def test_weights_repeat_by_seed_and_layer():
    dm = _dims()
    a = draw.weights(dm, 4, CPU)
    b = dict(draw.leaves(dm, 4, CPU))
    c = draw.weights(dm, 5, CPU)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.1.attn.wq"], c["layers.1.attn.wq"])
    assert not torch.equal(a["layers.0.attn.wq"], a["layers.1.attn.wq"])
    assert torch.equal(a["lm_head"],
                       draw.group(dm, ("lm_head",), 4, CPU)["lm_head"])
    assert torch.equal(a["layers.1.mlp.up"],
                       draw.layer(dm, 1, 4, CPU)["mlp.up"])
    std = float(a["layers.0.mlp.up"].std())
    assert abs(std - dm.init_std) < 0.1 * dm.init_std
