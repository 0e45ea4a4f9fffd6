"""The plain reference against the port, on the small copies of both
configurations in float32 on the CPU: serving logits after a prefill and
decode steps, and three train steps' losses, gradients and changes."""
import torch

import small
from perfbench.generators import length_grouped, packed_text
from perfbench.harness import compare, draw, program
from perfbench.reference import dense

CPU = torch.device("cpu")


def _f32(name):
    c = small.config(name)
    c = dict(c, run=dict(c["run"], compute_dtype="float32"))
    dm = dense.Dims.from_file(c)
    cfg, _ = program.model_config(c, dense.program_fields(dm, c))
    return dm, cfg


def test_serving_logits_match_the_port():
    dm, cfg = _f32("yi-34b")
    feed = length_grouped.Feed(small.traffic("code-completion"), dm, 11, CPU)
    flat = draw.weights(dm, 11, CPU)
    model = program.model(cfg, flat, trainable=False)
    prefill, decode = program.serve_steps(cfg)
    S, answers = feed.shape(0)
    n = max(answers)
    cache = model.init_cache(feed.B, S + n)
    logits, cache = prefill(model, cache, feed.batch(0))
    got, toks = [logits[:, -1]], []
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    toks.append(tok)
    for _ in range(n - 1):
        logits, tok, cache = decode(model, cache, {"tokens": tok[:, None]})
        got.append(logits[:, -1])
        toks.append(tok)
    got, toks = torch.stack(got, 1), torch.stack(toks, 1)
    requests = [(feed.request(0, row, toks[row].tolist()), n)
                for row in range(feed.B)]
    want = dense.serve_logits(dm, flat["embed"],
                              lambda i: dense.layer_params(flat, i),
                              flat["lm_head"], flat["final_norm"], requests)
    for row in range(feed.B):
        torch.testing.assert_close(got[row], want[row], rtol=1e-4, atol=1e-4)
        assert compare.token_gap(want[row], toks[row].tolist()) == 0.0


def test_train_steps_match_the_port():
    dm, cfg = _f32("yi-34b-4l")
    t = small.traffic("pretrain-4k")
    model = program.model(cfg, draw.weights(dm, 5, CPU), trainable=True)
    opt = program.adamw_init(model)
    tc = dict(t["optimizer"], grad_accum=1)
    step = program.train_step(cfg, tc)
    feed = packed_text.Feed(t, dm, 5, CPU)
    losses, grads = [], None
    for i in range(3):
        model, opt, m = step(model, opt, feed.batch(i))
        losses.append(float(m["loss"]))
        if i == 0:
            scale = min(1.0, 1.0 / max(float(m["grad_norm"]), 1e-9))
            grads = {k: float(v.double().norm()) / (0.1 * scale)
                     for k, v in opt.mu.items()}
    params = dict(model.named_parameters())
    change = {k: float((params[k].detach() - v).double().norm())
              for k, v in draw.leaves(dm, 5, CPU)}
    ref = dense.train(dm, draw.weights(dm, 5, CPU), feed.reference_batch,
                      tc, 3, 2, lambda: draw.leaves(dm, 5, CPU))
    got = compare.train_numbers(
        {"losses": losses, "grad_norms": grads, "change_norms": change}, ref)
    assert got["loss_gap"] < 1e-5
    assert got["grad_norm_gap"] < 1e-4
    assert got["change_norm_gap"] < 1e-3


def test_the_reference_refuses_what_it_does_not_compute():
    c = small.config("yi-34b")
    for bad in ({"hidden_act": "gelu"}, {"attention_bias": True},
                {"rope_scaling": {"type": "linear", "factor": 4.0}}):
        try:
            dense.Dims.from_file({**c, **bad})
        except ValueError:
            continue
        raise AssertionError(f"accepted {bad}")
