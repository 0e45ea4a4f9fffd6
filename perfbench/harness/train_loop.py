"""The training loop: one client drives the program's train step on fresh
rows, reading each step's loss on the host as a training loop does.

Set-up builds the model (float32 masters on the weights drawn from the
seed), AdamW's state and the step, and drives them through the checked
steps, which the reference follows after the window; the window then goes
on with the same objects.  ``train_tokens_per_s`` is every token of every
step completed in the window over the window.
"""
from __future__ import annotations

import math
import time

from . import compare, draw, program, yardstick
from .trace import profile, span


def _change_norms(dm, model, seed, device) -> dict:
    """Each leaf's distance from its drawn start, the start drawn again
    one layer at a time."""
    params = dict(model.named_parameters())
    return {n: float((params[n].detach() - t).double().norm())
            for n, t in draw.leaves(dm, seed, device)}


def run(r):
    ref, dm, t, dev = r.ref, r.dims, r.traffic, r.device
    cfg, r.work["moved"] = program.model_config(
        r.config, ref.program_fields(dm, r.config))
    model = program.model(cfg, draw.weights(dm, r.seed, dev), trainable=True)
    opt = program.adamw_init(model)
    r.phase("model")
    tc = dict(t["optimizer"], grad_accum=t["microbatches"])
    step = program.train_step(cfg, tc)
    feed = r.feeds.Feed(t, dm, r.seed, dev)
    names = [n for n, _ in model.named_parameters()]
    state = {"model": model, "opt": opt}

    def one(i):
        with span("make_inputs"):
            batch = feed.batch(i)
        with span("train_step"):
            state["model"], state["opt"], m = step(state["model"],
                                                   state["opt"], batch)
        with span("loss_read"):
            return float(m["loss"]), m

    checked = t["checked_steps"]
    losses, grad_norms = [], None
    for i in range(checked):
        loss, m = one(i)
        losses.append(loss)
        r.phase(f"step{i}")
        if i == 0:
            # AdamW's first moment after one step is (1 - beta1) g scale,
            # scale the clip's factor from the global norm it reports
            gn = float(m["grad_norm"])
            scale = min(1.0, tc["grad_clip"] / max(gn, 1e-9))
            mu = state["opt"].mu
            grad_norms = {n: float(mu[n].double().norm())
                          / ((1 - tc["beta1"]) * scale) for n in names}
    prog = {"losses": losses, "grad_norms": grad_norms,
            "change_norms": _change_norms(dm, state["model"], r.seed, dev)}
    r.mark_setup()

    r.reset_peak()
    i, steps, bad = checked, 0, 0
    t0 = time.perf_counter()
    while True:
        loss, _ = one(i)
        i, steps = i + 1, steps + 1
        bad += not math.isfinite(loss)
        if time.perf_counter() - t0 >= r.seconds:
            break
    window_s = time.perf_counter() - t0
    tokens = steps * feed.tokens_per_step
    r.host.update(window_s=window_s, steps=steps, tokens=tokens,
                  flops=steps * yardstick.train_step_flops(dm, feed.B,
                                                           feed.S))
    r.e2e["train_tokens_per_s"] = tokens / window_s
    r.attempted, r.failed = steps, bad
    if r.trace:
        n = t["trace_steps"]
        r.traced = profile(lambda: [one(i + j) for j in range(n)])
        r.work.update(steps=n, B=feed.B, S=feed.S)
    r.read_peak()

    state.clear()
    del model, opt, m
    r.free()
    ref.highest_precision()
    out = ref.train(dm, draw.weights(dm, r.seed, dev), feed.reference_batch,
                    tc, checked, t["reference_rows"],
                    lambda: draw.leaves(dm, r.seed, dev))
    r.work["worst"] = {}
    r.checks.update(compare.train_numbers(prog, out, r.work["worst"]))
    r.phase("reference")
