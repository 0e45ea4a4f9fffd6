"""A traced window: ``torch.profiler`` over a few units of work, reduced to
the device's busy time, kernel time by name, and idle time by what the
host was doing.

The reduction reads the profiler's raw events
(``prof.profiler.kineto_results.events()``; ``prof.events()`` first builds
the tree of every CPU operator, which takes minutes on long windows), as
``chip_smoke.py::profile_window`` does.  Busy time is the union of every
device event's interval.  An idle gap is named by the benchmark span
(``torch.profiler.record_function`` around its calls into each layer)
that covers the gap's midpoint on the host, or ``host_other``.
"""
from __future__ import annotations

import dataclasses
import re
import time

import torch

SPANS = ("make_inputs", "train_step", "loss_read", "prefill", "decode_step",
         "argmax_read")


def span(name: str):
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list            # (name, seconds) of each device event
    idle_by_span: dict       # span name -> idle seconds

    def kernel_time(self, pattern: str) -> tuple[float, int]:
        """Summed seconds and count of the device events whose name
        matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [s for n, s in self.kernels if rx.search(n)]
        return sum(hits), len(hits)

    def top_ops(self, n=10):
        by = {}
        for name, s in self.kernels:
            by[name] = by.get(name, 0.0) + s
        return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:n]

    def top_gaps(self, n=10):
        return sorted(([k, v] for k, v in self.idle_by_span.items()),
                      key=lambda r: -r[1])[:n]


def _short(name: str) -> str:
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name[:96]


def profile(fn) -> Trace:
    """Run ``fn`` once under the profiler, the card synchronised on both
    sides, and reduce its events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with span("window"):
            fn()
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a span also shows on the device's timeline, around the kernels
            # it launched: that is no device work of its own
            if e.name() not in SPANS and e.name() != "window":
                dev.append((a, b, _short(e.name())))
        elif e.name() in SPANS:
            spans.append((a, b, e.name()))
        elif e.name() == "window":
            window = (a, b)
    if not dev or window is None:
        return Trace(window_s, 0.0, [], {})
    dev.sort()
    start, end = window              # the window in the events' clock
    busy, idle, cur = 0, {}, start
    for a, b, _ in dev:
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if a > cur:
            _add_gap(idle, spans, cur, a)
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if end > cur:
        _add_gap(idle, spans, cur, end)
    return Trace(window_s=window_s, busy_s=busy / 1e9,
                 kernels=[(n, (b - a) / 1e9) for a, b, n in dev],
                 idle_by_span={k: v / 1e9 for k, v in idle.items()})


def _add_gap(idle: dict, spans, a: int, b: int):
    mid = (a + b) // 2
    name = "host_other"
    for s, e, n in spans:
        if s <= mid < e:
            name = n
            break
    idle[name] = idle.get(name, 0) + (b - a)
