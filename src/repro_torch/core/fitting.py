"""Least-squares fitting of preemption models to empirical lifetime CDFs
(the paper's Eq. 1 fit, Fig. 1), in PyTorch.

Port of ``repro.core.fitting``: a Levenberg-Marquardt loop with
multiplicative damping over an unconstrained parameter vector ``theta``,
Jacobians from ``torch.func.jacfwd``, multi-starts per family and the
goodness-of-fit statistics.  Every fit computes in float64 on the device of
its inputs; the loop reads one accept/stop decision back to the host an
iteration.  Families map ``theta`` to positive or bounded natural
parameters through ``softplus`` and ``sigmoid``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from . import distributions as dist_mod
from .distributions import (DEADLINE_HOURS, Constrained, Empirical,
                            Exponential, GompertzMakeham, Weibull)

_F64 = torch.float64


class FitDiverged(RuntimeError):
    """A fit produced non-finite parameters or loss and no finite
    multi-start rescued it; a refit loop keeps its last good model."""


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y):
    y = torch.as_tensor(y, dtype=_F64)
    return torch.log(torch.expm1(torch.clamp(y, min=1e-6)))


def _sigmoid(x):
    return torch.sigmoid(x)


def _inv_sigmoid(y):
    y = torch.clamp(torch.as_tensor(y, dtype=_F64), 1e-6, 1 - 1e-6)
    return torch.log(y / (1.0 - y))


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    n_params: int
    build: Callable    # (theta, L) -> distribution
    theta0: Callable   # (t, y, L) -> initial unconstrained theta
    # extra residuals appended to the data residuals (boundary conditions)
    boundary: Callable = lambda d: d._f64(0.0).new_zeros((0,))
    # multi-start inits (best final LSE wins)
    extra_theta0: tuple = ()


def _build_constrained(theta, L):
    return Constrained(tau1=_softplus(theta[0]), tau2=_softplus(theta[1]),
                       b=_softplus(theta[2]), A=_sigmoid(theta[3]), L=L)


def _build_exponential(theta, L):
    return Exponential(mttf=_softplus(theta[0]), L=L)


def _build_weibull(theta, L):
    return Weibull(lam=_softplus(theta[0]), k=_softplus(theta[1]), L=L)


def _build_gm(theta, L):
    return GompertzMakeham(lam=_softplus(theta[0]),
                           alpha=1e-3 * _softplus(theta[1]),
                           beta=_softplus(theta[2]), L=L)


def _stack(*xs):
    return torch.stack([torch.as_tensor(x, dtype=_F64) for x in xs])


def _mean_t(t):
    return torch.clamp(torch.mean(t), min=0.5).cpu()


FAMILIES = {
    "constrained": Family(
        name="constrained", n_params=4, build=_build_constrained,
        theta0=lambda t, y, L: _stack(
            _inv_softplus(1.0), _inv_softplus(1.0),
            _inv_softplus(0.95 * float(L)), _inv_sigmoid(0.45)),
        # paper: the 4 fit parameters together keep F(0) ~= 0; a weight-3
        # penalty on the raw (unclipped) Eq. 1 at t = 0
        boundary=lambda d: 3.0 * d.cdf_raw(0.0)[None],
    ),
    "exponential": Family(
        name="exponential", n_params=1, build=_build_exponential,
        theta0=lambda t, y, L: _stack(_inv_softplus(_mean_t(t))),
    ),
    "weibull": Family(
        name="weibull", n_params=2, build=_build_weibull,
        theta0=lambda t, y, L: _stack(_inv_softplus(1.0 / _mean_t(t)),
                                      _inv_softplus(1.0)),
    ),
    "gompertz_makeham": Family(
        name="gompertz_makeham", n_params=3, build=_build_gm,
        theta0=lambda t, y, L: _stack(_inv_softplus(0.1),
                                      _inv_softplus(0.1),
                                      _inv_softplus(0.3)),
        extra_theta0=(
            lambda t, y, L: _stack(_inv_softplus(0.05), _inv_softplus(1.0),
                                   _inv_softplus(0.6)),
            # deadline-wall start: alpha ~ 1e-3*softplus(-14) ~ 1e-9, beta ~ 1
            lambda t, y, L: _stack(_inv_softplus(0.05), -14.0,
                                   _inv_softplus(1.0)),
        ),
    ),
}


def _model_cdf(dist):
    """Fitting target: the raw model curve where there is one (the clip in
    ``Constrained.cdf`` would zero gradients at the boundary)."""
    return dist.cdf_raw if hasattr(dist, "cdf_raw") else dist.cdf


@dataclasses.dataclass(frozen=True)
class FitResult:
    dist: object
    theta: torch.Tensor
    lse: torch.Tensor          # sum of squared CDF residuals (data terms)
    iterations: int
    converged: bool


def levenberg_marquardt(residual_fn, theta0, max_iters: int = 200,
                        mu0: float = 1e-2, tol: float = 1e-9):
    """Classic LM with multiplicative damping; minimizes ``||r||^2`` for
    ``residual_fn: theta -> r``.

    A step that is not finite (singular ``JtJ``, NaN residuals or
    Jacobian) is replaced by a zero step, so the iterate never becomes
    non-finite; a candidate is accepted only when its loss is finite (and
    below the current one, when that is finite).  Each accepted step
    divides the damping by 3 (floor 1e-12), each rejected one doubles it
    (cap 1e8); the loop stops after ``max_iters`` iterations or at the
    first accepted step that moves the loss by less than
    ``tol * (1 + loss)``.  ``converged`` is that stop with a finite theta
    and loss.  Non-finite entries of ``theta0`` are zeroed on entry.

    Returns ``(theta, loss, iterations, converged)``.
    """
    jac = torch.func.jacfwd(residual_fn)

    def loss(theta):
        r = residual_fn(theta)
        return torch.sum(r * r)

    theta = torch.as_tensor(theta0, dtype=_F64)
    theta = torch.where(torch.isfinite(theta), theta,
                        torch.zeros_like(theta))
    prev = loss(theta)
    mu, i, done = float(mu0), 0, False
    while i < max_iters and not done:
        r = residual_fn(theta)
        J = jac(theta)
        JtJ = J.T @ J
        g = J.T @ r
        # LM step: (JtJ + mu*diag(JtJ)) delta = -g
        damp = mu * torch.diag(torch.clamp(torch.diag(JtJ), min=1e-10))
        delta, info = torch.linalg.solve_ex(JtJ + damp, -g)
        ok_step = (info == 0) & torch.all(torch.isfinite(delta))
        delta = torch.where(ok_step, delta, torch.zeros_like(delta))
        cand = theta + delta
        new = loss(cand)
        new_f, prev_f = float(new), float(prev)
        accept = bool(np.isfinite(new_f)) and (
            new_f < prev_f if np.isfinite(prev_f) else True)
        if accept:
            theta, prev = cand, new
            mu = max(mu / 3.0, 1e-12)
            done = abs(prev_f - new_f) < tol * (1.0 + prev_f)
        else:
            mu = min(mu * 2.0, 1e8)
        i += 1
    converged = done and bool(torch.all(torch.isfinite(theta))) \
        and bool(torch.isfinite(prev))
    return theta, prev, i, converged


def _fit_runs(t, y, L, family: str, max_iters: int):
    """Every multi-start's LM run and the best-LSE selection: non-finite
    final losses rank last, ties keep the earliest init."""
    fam = FAMILIES[family]

    def residual(theta):
        d = fam.build(theta, L)
        r = _model_cdf(d)(t) - y
        return torch.cat([r, fam.boundary(d)])

    runs = [levenberg_marquardt(residual,
                                init(t, y, L).to(t.device),
                                max_iters=max_iters)
            for init in (fam.theta0, *fam.extra_theta0)]
    losses = [float(run[1]) for run in runs]
    ranked = [x if np.isfinite(x) else np.inf for x in losses]
    best = int(np.argmin(ranked))
    theta, _, iters, conv = runs[best]
    d = fam.build(theta, L)
    data_r = _model_cdf(d)(t) - y
    return theta, torch.sum(data_r * data_r), iters, conv


def fit(family: str, t, y, L=DEADLINE_HOURS, max_iters: int = 200,
        device="cuda") -> FitResult:
    """Fit a family's CDF to points (t, y) by least squares (the paper's
    Eq. 1 fit), in float64 on ``device``."""
    dev = resolve_device(device)
    fam = FAMILIES[family]
    t = torch.as_tensor(np.asarray(t, np.float64), device=dev)
    y = torch.as_tensor(np.asarray(y, np.float64), device=dev)
    L = torch.as_tensor(float(L), dtype=_F64, device=dev)
    theta, lse_v, iters, done = _fit_runs(t, y, L, family, int(max_iters))
    return FitResult(dist=fam.build(theta, L), theta=theta, lse=lse_v,
                     iterations=iters, converged=done)


def fit_samples(family: str, samples, L=DEADLINE_HOURS, device="cuda",
                **kw) -> FitResult:
    """Fit directly to a lifetime trace via its empirical CDF.

    Degenerate traces raise ``ValueError`` before the optimizer sees them:
    an empty trace, any non-finite lifetime, a trace whose every lifetime
    sits at the deadline cap ``L`` (nothing for Eq. 1's soft phases to
    fit), and a constant trace (a zero-spread empirical CDF).
    """
    s = np.asarray(samples, np.float64).ravel()
    if s.size == 0:
        raise ValueError("fit_samples: empty lifetime trace")
    if not np.all(np.isfinite(s)):
        raise ValueError(
            f"fit_samples: {int((~np.isfinite(s)).sum())}/{s.size} "
            f"non-finite lifetimes in trace")
    if np.all(s >= float(L) - 1e-9):
        raise ValueError(
            "fit_samples: every lifetime sits at the deadline cap "
            f"L={float(L):g} h; the empirical CDF is a single atom and "
            "Eq. 1's soft phases are unidentifiable")
    if np.ptp(s) == 0.0:
        raise ValueError(
            f"fit_samples: constant trace (all lifetimes == {s[0]:g} h); "
            "a zero-spread empirical CDF cannot constrain the fit")
    emp = Empirical.from_samples(s, L=L)
    return fit(family, emp.knots.numpy(), emp.values.numpy(), L=L,
               device=device, **kw)


def fit_all(samples, L=DEADLINE_HOURS,
            families=("constrained", "exponential", "weibull",
                      "gompertz_makeham"), device="cuda"):
    """Fit every family to a trace: ``{family: FitResult}`` (Fig. 1/3)."""
    return {f: fit_samples(f, samples, L=L, device=device) for f in families}


# ---------------------------------------------------------------------------
# goodness of fit
# ---------------------------------------------------------------------------

def _like(dist, x):
    return torch.as_tensor(x, dtype=_F64, device=dist.device)


def ks_statistic(dist, samples):
    """Kolmogorov-Smirnov sup |F_model - F_empirical| over the sample
    points."""
    s = torch.sort(_like(dist, samples).reshape(-1)).values
    n = s.shape[0]
    f = dist.cdf(s)
    lo = torch.arange(n, dtype=f.dtype, device=f.device) / n
    hi = (torch.arange(n, dtype=f.dtype, device=f.device) + 1.0) / n
    return torch.maximum(torch.max(torch.abs(f - lo)),
                         torch.max(torch.abs(f - hi)))


def lse(dist, t, y):
    r = dist.cdf(_like(dist, t)) - _like(dist, y)
    return torch.sum(r * r)


def qq_points(dist, samples, n_q: int = 99):
    """QQ plot data (the paper's Fig. 3): model quantiles against empirical
    quantiles, the model CDF inverted on [0, 3L] so unconstrained fits can
    overshoot L."""
    emp = Empirical.from_samples(_like(dist, samples))
    q = (torch.arange(n_q, dtype=_F64, device=emp.knots.device) + 1.0) \
        / (n_q + 1.0)
    emp_q = emp.quantile(q)
    L3 = 3.0 * dist._f64(dist.L)
    model_q = dist_mod._bisect_icdf(
        dist.cdf, torch.minimum(q, dist.cdf(L3) - 1e-6), 0.0, L3)
    return q, emp_q, model_q
