"""The port's spans (``repro_torch.tracing``) on the CPU at smoke size.

Off, the steps record nothing.  Under ``tracing.recording()`` and under
``torch.profiler`` they record the spans of the train and serving steps,
with their counts, parents, units and tokens; the profiler's own events
for the ops a span ran fall inside the span's interval on the shared
clock; recording changes no number the steps compute; the record keeps at
most ``tracing.CAP`` spans and counts the rest.
"""
import collections
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, tracing
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import serve as TS
from repro_torch.launch import steps
from repro_torch.launch import train as TTR
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

ARCH = "yi-34b"          # smoke: 2 attention layers, untied head, remat
B, S, N_DECODE = 3, 12, 3


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


MODES = {"off": contextlib.nullcontext, "recording": tracing.recording,
         "profiler": _cpu_profile}


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.clear()
    yield
    tracing.clear()


def _cfg(**over):
    return dataclasses.replace(configs.smoke(ARCH), **over)


def _train_step(cfg, mode):
    """One train step of a fresh model in ``mode``; returns its loss and
    parameters."""
    model = T.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                   trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, TrainConfig(warmup_steps=1))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
             for k in ("tokens", "labels")}
    with MODES[mode]():
        model, _, m = step(model, opt, batch)
    return m["loss"], [p.detach().clone() for p in model.parameters()]


def _serve(cfg, mode, batches=1):
    """A prefill and N_DECODE decode steps a batch, in ``mode``; returns
    each step's logits and the tokens."""
    model = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    gen = torch.Generator().manual_seed(2)
    out = []
    with MODES[mode]():
        for _ in range(batches):
            prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
            cache = model.init_cache(B, S + N_DECODE)
            logits, cache = prefill(model, cache, {"tokens": prompts})
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            out += [logits, tok]
            for _ in range(N_DECODE):
                logits, tok, cache = decode(model, cache,
                                            {"tokens": tok[:, None]})
                out += [logits, tok]
    return out


def _counts(record):
    return collections.Counter(s.name for s in record)


def test_off_records_nothing():
    _train_step(_cfg(), "off")
    _serve(_cfg(), "off")
    assert tracing.spans() == [] and tracing.dropped() == 0
    assert tracing.span("step.train") is tracing.span("block.attn")


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_train_step_spans(mode, remat):
    cfg = _cfg(remat=remat)
    _train_step(cfg, mode)
    record = tracing.spans()
    L = cfg.n_layers
    per_layer = 2 * L if remat else L
    assert _counts(record) == {
        "step.train": 1, "step.forward": 1, "step.backward": 1,
        "step.optimizer": 1, "model.embed": 1, "model.unembed": 1,
        "model.loss": 1, "block.attn": per_layer,
        "block.attention": per_layer, "block.mlp": per_layer}
    train = record[0]
    assert train.name == "step.train" and train.parent is None
    assert train.tokens == B * S
    assert {s.unit for s in record} == {train.unit}
    parents = {s.name: s.parent.name for s in record if s.parent}
    assert parents["step.forward"] == parents["step.optimizer"] \
        == "step.train"
    assert parents["model.loss"] == "step.forward"
    assert parents["block.attention"] == parents["block.mlp"] \
        == "block.attn"
    attn = [s.parent.name for s in record if s.name == "block.attn"]
    # under remat each layer reruns inside the backward
    assert attn == ["step.forward"] * L + ["step.backward"] * (
        per_layer - L)
    for s in record:
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
    rows = tracing.summary(record)
    assert all(r["self_ms"] >= 0 and r["self_ms"] <= r["host_ms"]
               and r["device_ms"] is None for r in rows.values())
    assert rows["step.train"]["tokens"] == B * S


@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_serving_spans_share_their_batch_unit(mode):
    cfg = _cfg()
    _serve(cfg, mode, batches=2)
    record = tracing.spans()
    L, passes = cfg.n_layers, 2 * (1 + N_DECODE)
    assert _counts(record) == {
        "step.prefill": 2, "step.decode": 2 * N_DECODE,
        "decode.eager": 2 * N_DECODE,
        "model.embed": passes, "model.unembed": passes,
        "block.attn": L * passes, "block.attention": L * passes,
        "block.mlp": L * passes}
    prefills = [s for s in record if s.name == "step.prefill"]
    assert [s.tokens for s in prefills] == [B * S] * 2
    assert prefills[0].unit != prefills[1].unit
    for s in record:
        if s.name == "step.decode":
            assert s.parent is None and s.tokens == B
        if s.name == "decode.eager":
            # off CUDA every step runs eagerly, never from a graph
            assert s.parent.name == "step.decode"
        # every span of a batch carries its prefill's unit
        batch = prefills[1] if s.start_ns >= prefills[1].start_ns \
            else prefills[0]
        assert s.unit == batch.unit


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b",
                                  "moonshot-v1-16b-a3b"])
def test_a_span_for_each_block_kind(arch):
    cfg = configs.smoke(arch)
    model = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with tracing.recording(), torch.no_grad():
        model(tokens, mode="prefill", cache=model.init_cache(2, 8))
    blocks = {n: c for n, c in _counts(tracing.spans()).items()
              if n in T.BLOCK_SPANS.values()}
    assert blocks == {T.BLOCK_SPANS[k]: c for k, c in
                      collections.Counter(T.layer_kinds(cfg)).items()}


def test_profiler_events_fall_inside_their_spans():
    """The kineto events of the ops a span ran lie inside its interval on
    the profiler's clock, to 50 us: each decode step's in-step argmax
    inside its ``step.decode``; the caller's own argmax, between the
    prefill's return and the first decode step, after the one and before
    the other."""
    cfg = _cfg()
    with _cpu_profile() as prof:
        _serve(cfg, "off")
    record = tracing.spans()
    argmax = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in
                    prof.profiler.kineto_results.events()
                    if e.name() == "aten::argmax")
    assert len(argmax) == 1 + N_DECODE
    slack = 50_000

    def inside(t, s):
        return s.start_ns - slack <= t <= s.end_ns + slack

    (prefill,) = [s for s in record if s.name == "step.prefill"]
    decodes = [s for s in record if s.name == "step.decode"]
    for (a, b), s in zip(argmax[1:], decodes):
        assert inside(a, s) and inside(b, s)
    assert prefill.end_ns <= argmax[0][0] < argmax[0][1] \
        <= decodes[0].start_ns
    # an op run inside a span of its own, and the span's ends on the clock
    with _cpu_profile() as prof:
        with tracing.span("probe") as probe:
            torch.cumsum(torch.ones(64, 64), 0)
    (e,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::cumsum"]
    assert inside(e.start_ns(), probe)
    assert inside(e.start_ns() + e.duration_ns(), probe)


@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_recording_changes_no_number(mode):
    cfg = _cfg()
    loss_off, params_off = _train_step(cfg, "off")
    loss_on, params_on = _train_step(cfg, mode)
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))
    served_off, served_on = _serve(cfg, "off"), _serve(cfg, mode)
    assert all(torch.equal(a, b) for a, b in zip(served_off, served_on))
    assert len(tracing.spans()) > 0


def test_summary_self_time_subtracts_children():
    with tracing.recording():
        with tracing.span("outer", tokens=5):
            for _ in range(2):
                with tracing.span("inner"):
                    torch.ones(8).sum()
        with tracing.span("outer"):
            pass
    record = tracing.spans()
    rows = tracing.summary(record)
    outer = [s for s in record if s.name == "outer"]
    inner = [s for s in record if s.name == "inner"]
    assert rows["outer"]["count"] == 2 and rows["outer"]["tokens"] == 5
    want = sum(s.end_ns - s.start_ns for s in outer) - sum(
        s.end_ns - s.start_ns for s in inner)
    assert rows["outer"]["self_ms"] == pytest.approx(want / 1e6)
    assert rows["inner"]["self_ms"] == rows["inner"]["host_ms"]
    assert "outer" in tracing.table(rows)


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 5)
    with tracing.recording():
        for i in range(8):
            with tracing.span(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == [f"s{i}" for i in range(5)]
    assert tracing.dropped() == 3
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_cli_trace_prints_the_summary(tmp_path, capsys):
    TS.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batches", "1",
             "--decode", "3", "--trace"])
    out = capsys.readouterr().out
    assert "step.prefill" in out and "step.decode" in out
    tracing.clear()
    TTR.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
              "--ckpt-dir", str(tmp_path), "--trace"])
    out = capsys.readouterr().out
    assert "step.optimizer" in out and "block.attn" in out
