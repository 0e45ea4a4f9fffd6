"""The metrics read from the program's own spans (``repro_torch.tracing``):
None with no record, the host metric's mean from a record that the small
copies' steps made under the CPU profiler, and None on the CPU from the
device-timed ones, whose spans carry no device time there."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import small
from perfbench.harness import cell, draw, program
from repro_torch import tracing

DEVICE_TIMED = ("train_forward_ms", "train_backward_ms", "adamw_ms")
HOST = "decode_issue_ms_per_step"


def _read(name):
    return cell.reader(cell.BENCH / "metrics" / f"{name}.py")(None)


def _small(conf):
    c = small.config(conf)
    ref = cell.module("reference", c["reference"])
    dm = ref.Dims.from_file(c)
    cfg, _ = program.model_config(c, ref.program_fields(dm, c))
    return cfg, dm


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.clear()
    yield
    tracing.clear()


@pytest.mark.parametrize("name", DEVICE_TIMED + (HOST,))
def test_no_record_reads_none(name):
    assert tracing.spans() == []
    assert _read(name) is None


def test_decode_issue_ms_is_the_mean_of_the_decode_spans():
    cfg, dm = _small("yi-34b")
    cpu = torch.device("cpu")
    model = program.model(cfg, draw.weights(dm, 7, cpu), trainable=False)
    prefill, decode = program.serve_steps(cfg)
    tokens = torch.randint(0, dm.vocab, (3, 10),
                           generator=torch.Generator().manual_seed(7))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            cache = model.init_cache(3, 14)
            logits, cache = prefill(model, cache, {"tokens": tokens})
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            for _ in range(3):
                _, tok, cache = decode(model, cache, {"tokens": tok[:, None]})
    steps = [s for s in tracing.spans() if s.name == "step.decode"]
    assert len(steps) == 6
    want = sum((s.end_ns - s.start_ns) / 1e6 for s in steps) / len(steps)
    assert _read(HOST) == pytest.approx(want, rel=1e-12)
    assert all(_read(n) is None for n in DEVICE_TIMED)


def test_device_timed_metrics_read_none_on_the_cpu():
    cfg, dm = _small("yi-34b-4l")
    cpu = torch.device("cpu")
    model = program.model(cfg, draw.weights(dm, 7, cpu), trainable=True)
    opt = program.adamw_init(model)
    step = program.train_step(cfg, dict(small.traffic("pretrain-4k")[
        "optimizer"], grad_accum=1))
    gen = torch.Generator().manual_seed(7)
    batch = {k: torch.randint(0, dm.vocab, (2, 12), generator=gen)
             for k in ("tokens", "labels")}
    with profile(activities=[ProfilerActivity.CPU]):
        step(model, opt, batch)
    rows = tracing.summary()
    assert {"step.train", "step.forward", "step.backward",
            "step.optimizer"} <= set(rows)
    assert all(r["device_ms"] is None for r in rows.values())
    assert all(_read(n) is None for n in DEVICE_TIMED)
    assert _read(HOST) is None
