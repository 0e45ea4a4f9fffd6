"""Online preemption-model maintenance (port of ``repro.core.online``; the
paper's Discussion: "a long-running cloud service can continuously update
the model based on recent preemption behavior" and "detect policy and
phase changes").

:class:`OnlineModelTracker` keeps a rolling window of observed lifetimes,
refits Eq. 1 periodically (``fitting.fit_samples`` on ``device``) and
flags a change point when recent observations are no longer consistent
with the live model (two-sided KS test).  The cut comes from the KS
sampling distribution: the live model was fitted on ``m`` samples and is
tested against ``n`` fresh ones, so under a stationary fleet the statistic
fluctuates like a two-sample KS,

    D_crit(alpha; m, n) = sqrt(-ln(alpha/2) / 2) * sqrt((m + n) / (m * n)),

(one-sample ``sqrt(-ln(alpha/2) / (2 n))`` when the fit count is unknown).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..device import resolve_device
from . import distributions, fitting


def ks_critical_value(alpha: float, n_recent: int,
                      n_fit: Optional[int] = None) -> float:
    """Asymptotic two-sided KS rejection cut at significance ``alpha``.

    ``n_recent`` is the size of the sample being tested; ``n_fit`` the
    sample count behind the reference CDF (None for an exact/analytic
    reference, giving the classical one-sample form).
    """
    c = math.sqrt(-math.log(alpha / 2.0) / 2.0)
    if n_fit is None:
        return c / math.sqrt(n_recent)
    return c * math.sqrt((n_fit + n_recent) / (n_fit * n_recent))


@dataclasses.dataclass
class OnlineModelTracker:
    window: int = 512              # lifetimes kept
    refit_every: int = 64          # observations between refits
    # change-point sensitivity: None derives the cut from ``ks_alpha`` and
    # the live sample counts; a float pins a fixed threshold
    ks_threshold: Optional[float] = None
    ks_alpha: float = 0.01
    min_samples: int = 64
    prior: Optional[object] = None  # distribution used before enough data
    # injectable fit (signature of fitting.fit_samples without device);
    # the closed-loop runtime routes refits through its fault envelope
    fit_fn: Optional[Callable] = None
    device: str = "cuda"           # where the default fit runs

    def __post_init__(self):
        dev = resolve_device(self.device)
        self._fit = self.fit_fn or functools.partial(fitting.fit_samples,
                                                     device=dev)
        self._obs = deque(maxlen=self.window)
        self._since_fit = 0
        self._fit_n: Optional[int] = None   # samples behind the live model
        self.model = self.prior or distributions.constrained_for()
        self.n_refits = 0
        self.change_points = 0
        self.last_ks = 0.0
        self.last_cut = float("inf")

    def observe(self, lifetime_hours: float) -> bool:
        """Record one preemption; returns True if the model was refit."""
        self._obs.append(float(lifetime_hours))
        self._since_fit += 1
        if len(self._obs) >= self.min_samples and \
                self._since_fit >= self.refit_every:
            self.refit()
            return True
        return False

    def _cut(self, n_recent: int) -> float:
        if self.ks_threshold is not None:
            return self.ks_threshold
        return ks_critical_value(self.ks_alpha, n_recent, self._fit_n)

    def defer_refit(self, n_obs: int):
        """Back off: no automatic refit for the next ``n_obs`` observations
        (the runtime's bounded retry-with-backoff after a failed refit)."""
        self._since_fit = self.refit_every - int(n_obs)

    def refit(self):
        """Change-point check + refit on the current window.

        On a CONFIRMED change point the window is first trimmed to the
        post-change observations (the recent slice the KS test flagged), so
        the refit tracks the post-drift fleet instead of a blend.

        Raises :class:`fitting.FitDiverged` when the fit returns non-finite
        parameters or loss and ``ValueError`` (from ``fit_samples``) on a
        degenerate window; either way the live model is left in place,
        ``change_points`` still records the detection, and the caller
        decides the retry policy (see ``FleetRuntime``).
        """
        data = np.asarray(self._obs)
        # change-point check BEFORE refitting: is the live model still
        # consistent with the recent half of the window?
        recent = data[-max(len(data) // 2, self.min_samples // 2):]
        self.last_ks = float(fitting.ks_statistic(self.model, recent))
        self.last_cut = self._cut(len(recent))
        if self.last_ks > self.last_cut and self.n_refits > 0:
            self.change_points += 1
            # drop pre-drift lifetimes: refit on post-change observations
            data = recent
            self._obs = deque(recent.tolist(), maxlen=self.window)
        res = self._fit("constrained", data)
        theta = np.asarray(res.theta.cpu(), np.float64)
        if not (np.all(np.isfinite(theta)) and np.isfinite(float(res.lse))):
            raise fitting.FitDiverged(
                f"refit on {len(data)} observations produced non-finite "
                f"theta/loss (theta={theta.tolist()})")
        self.model = res.dist
        self._fit_n = len(data)
        self.n_refits += 1
        self._since_fit = 0

    @property
    def drifted(self) -> bool:
        return self.last_ks > self.last_cut
