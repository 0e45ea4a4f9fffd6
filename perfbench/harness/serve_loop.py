"""The serving loop: one client hands the program a batch of requests,
waits for every one of its tokens, then hands it the next (a closed loop,
as an offline job over a queue of requests runs).

A batch goes as ``launch/serve.py::serve_batch`` drives the steps: a fresh
cache, the prefill over the prompts' tokens, the greedy first token read
on the host, then one decode step a token, each ending in the argmax that
the host reads, until the batch's longest answer is done; a request is
done with its own answer length, and completes with its batch.  The
window runs whole blocks of batches (``block`` in the mix) until it has
lasted ``--seconds``.  Set-up warms every batch shape of the mix on a
one-layer model that shares the served model's first layer, embedding
and head: the same kernels at the same shapes, one layer's share of the
work.  After the window a sample of finished requests, drawn from the
seed with the longest answer in it, goes through the reference's full
forward over the prompt and the served tokens.
"""
from __future__ import annotations

import dataclasses
import random
import time

import torch

from . import compare, draw, program, yardstick
from .trace import profile, span


def run(r):
    ref, dm, t, dev = r.ref, r.dims, r.traffic, r.device
    cfg, r.work["moved"] = program.model_config(
        r.config, ref.program_fields(dm, r.config))
    flat = draw.weights(dm, r.seed, dev, getattr(torch, dm.compute_dtype))
    model = program.model(cfg, flat, trainable=False)
    first = {k: v for k, v in flat.items()
             if not k.startswith("layers.") or k.startswith("layers.0.")}
    warm = program.model(dataclasses.replace(cfg, n_layers=1), first,
                         trainable=False)
    del flat, first
    feed = r.feeds.Feed(t, dm, r.seed, dev)
    prefill, decode = program.serve_steps(cfg)
    r.phase("model")
    B = feed.B

    def serve(m, b):
        S, answers = feed.shape(b)
        n_new = max(answers)
        with span("make_inputs"):
            batch = feed.batch(b)
            r.sync()
        handed = time.perf_counter()
        cache = m.init_cache(B, S + n_new)
        with span("prefill"):
            logits, cache = prefill(m, cache, batch)
        with span("argmax_read"):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            out = [tok.cpu()]
        ttft = time.perf_counter() - handed
        for _ in range(n_new - 1):
            with span("decode_step"):
                _, tok, cache = decode(m, cache, {"tokens": tok[:, None]})
            with span("argmax_read"):
                out.append(tok.cpu())
        return torch.stack(out, dim=1), ttft, time.perf_counter() - handed

    for b in range(len(feed.plan)):             # every shape, one layer
        serve(warm, b)
    del warm
    r.mark_setup()

    r.reset_peak()
    served, prefill_s, decode_s = [], 0.0, 0.0
    t0 = time.perf_counter()
    while True:
        toks, ttft, total = serve(model, len(served))
        served.append(toks)
        prefill_s += ttft
        decode_s += total - ttft
        if (len(served) % feed.block == 0
                and time.perf_counter() - t0 >= r.seconds):
            break
    window_s = time.perf_counter() - t0
    n = len(served)
    shapes = [feed.shape(b) for b in range(n)]
    bad = sum(int(((x < 0) | (x >= dm.vocab)).any(dim=1).sum())
              for x in served)
    steps = [max(a) for _, a in shapes]
    pf = sum(yardstick.prefill_flops(dm, B, S) for S, _ in shapes)
    df = sum(yardstick.decode_step_flops(dm, B, S + j + 1)
             for (S, _), k in zip(shapes, steps) for j in range(k - 1))
    r.host.update(window_s=window_s, batches=n, prefill_s=prefill_s,
                  prefill_flops=pf, flops=pf + df, decode_s=decode_s,
                  decode_steps=sum(k - 1 for k in steps))
    if dev.type == "cuda":
        r.host["alloc_retries"] = torch.cuda.memory_stats(dev).get(
            "num_alloc_retries", 0)
    r.e2e["serve_requests_per_s"] = n * B / window_s
    r.attempted, r.failed = n * B, bad
    if r.trace:
        k = t["trace_batches"]
        r.traced = profile(lambda: [serve(model, n + j) for j in range(k)])
        r.work.update(B=B, batches=[(S, max(a)) for S, a in
                                    (feed.shape(n + j) for j in range(k))])
        r.phase("traced")
    r.read_peak()

    del model
    r.free()
    ref.highest_precision()
    rng = random.Random(draw.derive(r.seed, "sample"))
    done = [(b, row) for b in range(n) for row in range(B)]
    longest = max(done, key=lambda q: shapes[q[0]][1][q[1]])
    rest = [q for q in done if q != longest]
    picks = [longest] + rng.sample(rest, min(t["check_requests"] - 1,
                                             len(rest)))
    requests, answers = [], []
    for b, row in picks:
        a = served[b][row, :shapes[b][1][row]].tolist()
        requests.append((feed.request(b, row, a), len(a)))
        answers.append(a)
    embed = draw.embedding(dm, r.seed, dev)
    head = embed.T if dm.tied else draw.head(dm, r.seed, dev)
    logits = ref.serve_logits(
        dm, embed, lambda i: draw.layer(dm, i, r.seed, dev), head,
        torch.ones(dm.d, device=dev), requests)
    gaps = [compare.token_gaps(x, a) for x, a in zip(logits, answers)]
    # (prompt length, answer length, where and how wide its widest gap)
    r.work["gaps"] = [(shapes[b][0], len(a), g.index(max(g)), max(g))
                      for (b, _), a, g in zip(picks, answers, gaps)]
    r.checks["token_gap"] = max(max(g) for g in gaps)
    r.phase("reference")
