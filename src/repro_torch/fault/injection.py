"""Deterministic fault injection for the closed-loop fleet runtime (port
of ``repro.fault.injection``; host numpy, copied as it is).

The runtime (``repro_torch.core.runtime.FleetRuntime``) streams lifetimes
through a refit -> re-solve -> table-swap pipeline; :class:`FaultInjector`
perturbs that pipeline with the four failure modes a long-running service
actually sees, on a fixed seeded schedule so every run replays the same
storm:

``drift``
    The fleet's preemption behavior changes regime at a known observation
    index (e.g. the provider moves capacity, a zone flips day/night policy).
    A stream-level fault: the lifetime source switches distribution and the
    runtime is expected to *detect* it (KS change-point), refit, and swap
    tables — the gap between injection and swap is the adaptation lag.

``storm``
    A preemption storm: for ``duration`` observations every lifetime draw is
    overridden with a near-immediate kill.  Stresses the degenerate-window
    guards in ``fit_samples`` (constant / all-tiny traces) and the tracker's
    change-point logic.

``fit_divergence``
    The next ``duration`` refits return non-finite parameters (the NaN /
    singular-``JtJ`` trace the LM hardening turns into ``converged=False``).
    A stage fault consumed by the runtime's fit stage; expected response is
    retry-with-backoff and last-good model/tables in the meantime.

``solve_timeout``
    The next ``duration`` DP solves exceed their wall-clock budget.  Stage
    fault on the solve stage; expected response is retry-with-backoff and
    serving from the last-good (stale) tables.

Events are *scheduled by observation index*, not wall time, so runs are
reproducible regardless of host speed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

KINDS = ("drift", "storm", "fit_divergence", "solve_timeout")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``at_obs``    observation index at which the fault arms.
    ``duration``  stream faults (storm): active for this many observations;
                  stage faults (fit_divergence / solve_timeout): a budget of
                  this many failures to inject on matching stage attempts.
    ``param``     kind-specific payload — drift: ``{"vm_types": (...)}`` or
                  ``{"dist": <distribution>}`` selecting the new regime;
                  storm: ``{"lifetime_hours": float}`` override draw.
    """
    kind: str
    at_obs: int
    duration: int = 1
    param: Optional[dict] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.at_obs < 0 or self.duration < 1:
            raise ValueError("at_obs must be >= 0 and duration >= 1")


@dataclasses.dataclass
class FaultInjector:
    """Replays a fixed schedule of :class:`FaultEvent`\\ s against the
    runtime.  All state advances with ``observation index`` (the runtime
    calls the query methods each observation / stage attempt), so a given
    ``(schedule, seed)`` pair injects the identical fault trace on every
    run — the CI quick tier depends on this.
    """
    schedule: Sequence[FaultEvent] = ()
    seed: int = 0

    def __post_init__(self):
        self.schedule = tuple(sorted(self.schedule, key=lambda e: e.at_obs))
        self._rng = np.random.default_rng(self.seed)
        # stage-fault budgets: remaining injections per armed event
        self._budgets = {}
        self._fired_drift = set()
        self.log: list[tuple[int, str, str]] = []   # (obs, kind, note)

    # -- stream faults -----------------------------------------------------
    def drift_event(self, obs: int) -> Optional[FaultEvent]:
        """The drift event firing exactly at ``obs`` (once), else None."""
        for i, ev in enumerate(self.schedule):
            if ev.kind == "drift" and ev.at_obs == obs \
                    and i not in self._fired_drift:
                self._fired_drift.add(i)
                self.log.append((obs, "drift", "regime switch"))
                return ev
        return None

    def storm_active(self, obs: int) -> Optional[FaultEvent]:
        """The storm covering ``obs`` (``at_obs <= obs < at_obs+duration``),
        else None."""
        for ev in self.schedule:
            if ev.kind == "storm" and ev.at_obs <= obs < ev.at_obs + ev.duration:
                return ev
        return None

    def storm_lifetime(self, ev: FaultEvent) -> float:
        """The overridden lifetime draw during a storm: near-immediate kill
        with a little jitter so the window isn't exactly constant unless the
        event pins ``lifetime_hours``."""
        p = ev.param or {}
        if "lifetime_hours" in p:
            return float(p["lifetime_hours"])
        return float(self._rng.uniform(0.01, 0.05))

    # -- stage faults ------------------------------------------------------
    def take(self, kind: str, obs: int) -> bool:
        """Consume one injection from an armed ``kind`` budget, if any.

        The runtime calls this at the top of the matching stage (fit stage
        -> ``fit_divergence``, solve stage -> ``solve_timeout``); True means
        "fail this attempt".  Each event supplies ``duration`` failures, so
        a bounded-retry runtime recovers once the budget drains.
        """
        for i, ev in enumerate(self.schedule):
            if ev.kind != kind or ev.at_obs > obs:
                continue
            left = self._budgets.get(i, ev.duration)
            if left > 0:
                self._budgets[i] = left - 1
                self.log.append((obs, kind, f"injected ({left - 1} left)"))
                return True
        return False

    def counts(self) -> dict:
        out = {k: 0 for k in KINDS}
        for ev in self.schedule:
            out[ev.kind] += 1
        return out


def default_schedule(n_obs: int, *,
                     drift_vm_types: tuple = ("n1-highcpu-32",)) -> tuple:
    """The benchmark/CI fault matrix scaled to an ``n_obs``-observation run:
    one drift regime switch at 40%, a preemption storm at 60%, two injected
    fit divergences right after the drift (so the first refit attempts fail
    and the retry path is exercised), and one solve timeout.

    The drift targets the harshest type (``n1-highcpu-32``, 1.45x the base
    hazard); paired with a gentle-fleet stream (``n1-highcpu-2``) the regime
    switch sits well above the tracker's two-sample KS cut — a mix-to-member
    switch lands within sampling noise of a 64-observation window and is NOT
    reliably detectable (measured: KS ~0.24 vs a ~0.25 cut)."""
    d = max(int(0.40 * n_obs), 1)
    return (
        FaultEvent("drift", d, param={"vm_types": drift_vm_types}),
        FaultEvent("fit_divergence", d, duration=2),
        FaultEvent("solve_timeout", d, duration=1),
        FaultEvent("storm", max(int(0.60 * n_obs), 2),
                   duration=max(n_obs // 20, 8)),
    )
