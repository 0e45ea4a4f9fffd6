"""Spans at the layer boundaries of the train and serving steps, kept in
memory.

``span(name)`` records only while recording is on: inside ``with
recording():`` (the operator's switch, ``--trace`` on the launchers) or
while a ``torch.profiler`` runs, so a profiled window carries the
program's spans with no further set-up.  Off, it returns one shared no-op
object after one check.  The spans are not
``torch.profiler.record_function`` ranges: such a range also shows on the
device's timeline, around the kernels it launched, where a reader of the
trace would count it as device work.

A span keeps its name, its start and end in host nanoseconds on the clock
of the profiler's events (``start_ns()``, Unix time), its parent, its unit
id and the tokens of a step.  Times are taken with
``time.perf_counter_ns()`` and moved to ``time.time_ns()`` by one offset,
taken again whenever a span opens with none open, so that a root span and
its children share one.  ``span(..., unit=True)`` opens a new unit (a
train step; a serving batch's prefill, which its decode steps join).  A
span given a CUDA ``device`` also records a pair of timing events on the
current stream; read when the record is read, their interval is the
stream's time between the span's two ends: the span's device time while
the card does not idle inside it.

Spans nest through one stack that every thread shares: a step's thread
waits in ``torch.autograd.grad`` while autograd's device thread runs the
backward and remat's recomputation, so spans still open and close in turn.
At most ``CAP`` spans are kept; ``dropped()`` counts the rest.
``count(name, n)`` keeps a counter as an instant span whose tokens are
``n``.
"""
from __future__ import annotations

import contextlib
import time

import torch

CAP = 1_000_000
_profiling = torch.autograd._profiler_enabled


class _Record:
    def __init__(self):
        self.forced = 0           # depth of ``recording()``
        self.kept, self.dropped = [], 0
        self.open = []            # open spans, innermost last
        self.unit, self.offset = 0, 0


_rec = _Record()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "parent", "unit", "tokens",
                 "device_ms", "_device", "_events", "_opens_unit")

    def __init__(self, name, device, tokens, opens_unit):
        self.name, self.tokens, self._device = name, tokens, device
        self.end_ns = self.device_ms = self._events = None
        self._opens_unit = opens_unit

    def __enter__(self):
        r = _rec
        if not r.open:
            r.offset = time.time_ns() - time.perf_counter_ns()
        r.unit += self._opens_unit
        self.unit = r.unit
        self.parent = r.open[-1] if r.open else None
        r.open.append(self)
        if len(r.kept) < CAP:
            r.kept.append(self)
            if self._device is not None and self._device.type == "cuda":
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(
                    torch.cuda.current_stream(self._device))
        else:
            r.dropped += 1
        self.start_ns = time.perf_counter_ns() + r.offset
        return self

    def __exit__(self, *exc):
        r = _rec
        self.end_ns = time.perf_counter_ns() + r.offset
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        r.open.remove(self)
        return False


def span(name: str, *, device: torch.device | None = None, tokens: int = 0,
         unit: bool = False):
    """A span named ``name`` while recording is on, else a shared no-op.
    ``device``: where the span's work runs (a CUDA device is timed with
    events); ``tokens``: the tokens a step counts; ``unit``: open a new
    unit."""
    if not (_rec.forced or _profiling()):
        return _OFF
    return Span(name, device, tokens, unit)


def count(name: str, n: int):
    """A counter while recording is on: an instant span named ``name``
    whose tokens carry ``n`` (the tower's attention pairs a step), so that
    ``summary`` sums it by name."""
    if _rec.forced or _profiling():
        with Span(name, None, int(n), False):
            pass


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    _rec.forced += 1
    try:
        yield
    finally:
        _rec.forced -= 1


def spans() -> list:
    """The kept spans, in the order they opened, left in the record; the
    device times of closed spans are read here (waiting for their
    events)."""
    for s in _rec.kept:
        if s._events is not None and s.end_ns is not None:
            a, b = s._events
            b.synchronize()
            s.device_ms, s._events = a.elapsed_time(b), None
    return list(_rec.kept)


def dropped() -> int:
    return _rec.dropped


def clear():
    _rec.kept, _rec.dropped = [], 0


def summary(record=None) -> dict:
    """By name: count, host ms, host self ms (the duration minus what its
    child spans cover), device ms (None where no span was timed) and
    tokens, over the closed spans of ``record`` (default ``spans()``)."""
    done = [s for s in (spans() if record is None else record)
            if s.end_ns is not None]
    covered = {}
    for s in done:
        if s.parent is not None:
            covered[id(s.parent)] = (covered.get(id(s.parent), 0)
                                     + s.end_ns - s.start_ns)
    out = {}
    for s in done:
        row = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                      "self_ms": 0.0, "device_ms": None,
                                      "tokens": 0})
        ns = s.end_ns - s.start_ns
        row["count"] += 1
        row["host_ms"] += ns / 1e6
        row["self_ms"] += (ns - covered.get(id(s), 0)) / 1e6
        if s.device_ms is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s.device_ms
        row["tokens"] += s.tokens
    return out


def table(rows: dict) -> str:
    """``summary``'s rows as a text table."""
    lines = [f"{'span':<18}{'count':>8}{'host ms':>12}{'self ms':>12}"
             f"{'device ms':>12}{'tokens':>10}"]
    for name, r in rows.items():
        dev = "-" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        lines.append(f"{name:<18}{r['count']:>8}{r['host_ms']:>12.3f}"
                     f"{r['self_ms']:>12.3f}{dev:>12}{r['tokens']:>10}")
    return "\n".join(lines)
