"""Lifetime models for temporally constrained preemptions (Eqs. 1-5), in
PyTorch.

Port of ``repro.core.distributions``: the paper's 4-parameter
constrained model

    F(t) = A * (1 - exp(-t/tau1) + exp((t-b)/tau2)),   0 < t < L (~24 h)

(:class:`Constrained`), its launch-phase-modulated form
(:class:`DiurnalConstrained`), the :class:`Exponential`,
:class:`Weibull`, :class:`GompertzMakeham` and :class:`Uniform` baselines
and the interpolated CDF of a trace (:class:`Empirical`).  Each is a
frozen dataclass whose fields are Python floats or float64 tensors;
every method computes in float64 on the device of its tensor fields (or
of the query, when that is a tensor).  :func:`stack` gives the fields a
leading ``(S,)`` scenario axis.  Time unit is HOURS.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# 24-hour maximum lifetime of Google Preemptible VMs.
DEADLINE_HOURS = 24.0

# Clip for exponent arguments to keep fitting iterates finite.
_EXP_CLIP = 60.0

# 64-point Gauss-Legendre rule on [-1, 1] (numeric partial expectations),
# with nodes and weights rounded to float32 as ``repro`` stores them; the
# sums themselves run in float64.
_GL_X, _GL_W = (x.astype(np.float32).astype(np.float64)
                for x in np.polynomial.legendre.leggauss(64))

_F64 = torch.float64


def _dist(cls):
    return dataclasses.dataclass(frozen=True, eq=False)(cls)


def _exp(x):
    return torch.exp(torch.clamp(x, -_EXP_CLIP, _EXP_CLIP))


def _clip(x, lo, hi):
    """``jnp.clip`` with tensor or scalar bounds: ``min(max(x, lo), hi)``."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _gauss_legendre(fn, a, b):
    """integral_a^b fn(x) dx with the fixed 64-point GL rule."""
    a, b = torch.broadcast_tensors(a, b)
    half = 0.5 * (b - a)
    mid = 0.5 * (a + b)
    gx = torch.as_tensor(_GL_X, dtype=_F64, device=a.device)
    gw = torch.as_tensor(_GL_W, dtype=_F64, device=a.device)
    x = mid[..., None] + half[..., None] * gx
    return half * torch.sum(gw * fn(x), dim=-1)


def _bisect_icdf(cdf_fn, u, lo, hi, iters: int = 64):
    """Invert a monotone CDF by bisection."""
    lo = torch.broadcast_to(torch.as_tensor(lo, dtype=u.dtype,
                                            device=u.device), u.shape)
    hi = torch.broadcast_to(torch.as_tensor(hi, dtype=u.dtype,
                                            device=u.device), u.shape)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf_fn(mid) < u
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


class _DistBase:
    """Generic implementations; families override where a closed form
    exists."""

    @property
    def device(self) -> torch.device:
        """Device of the first tensor field (CPU when all are floats)."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def _f64(self, t):
        if isinstance(t, torch.Tensor):
            return t.to(_F64)
        return torch.as_tensor(t, dtype=_F64, device=self.device)

    def survival(self, t):
        return 1.0 - self.cdf(t)

    def hazard(self, t):
        return self.pdf(t) / torch.clamp(self.survival(t), min=1e-12)

    def fail_between(self, a, b):
        """P(a < preemption <= b) = F(b) - F(a)."""
        return self.cdf(b) - self.cdf(a)

    def partial_expectation(self, a, b):
        """integral_a^b x f(x) dx (numeric fallback)."""
        return _gauss_legendre(lambda x: x * self.pdf(x), self._f64(a),
                               self._f64(b))

    def expected_lifetime(self):
        """E[L] = integral_0^L t f(t) dt (Eq. 3); the survivor mass at the
        deadline is excluded, as in the paper's definition."""
        return self.partial_expectation(0.0, self.L)

    def mean_lifetime_capped(self):
        """E[min(T, L)], the mass preempted AT the deadline included."""
        return (self.expected_lifetime()
                + self.survival(self.L) * self._f64(self.L))

    def icdf(self, u):
        return _bisect_icdf(self.cdf, self._f64(u), 0.0, self._f64(self.L))

    def sample(self, generator: torch.Generator, shape=()):
        """Lifetimes in [0, L] from float64 uniforms of ``generator`` (on
        the distribution's device): ``u >= F(L)`` means the VM survives to
        the hard cap and is preempted at exactly L."""
        u = torch.rand(tuple(shape), generator=generator, dtype=_F64,
                       device=self.device)
        L = self._f64(self.L)
        fl = self.cdf(L)
        t = self.icdf(torch.minimum(u, fl * (1.0 - 1e-6)))
        return torch.where(u >= fl, L.to(t.dtype), t)


@_dist
class Constrained(_DistBase):
    """The paper's constrained-preemption model (Eq. 1)."""

    tau1: float | torch.Tensor = 1.0
    tau2: float | torch.Tensor = 0.8
    b: float | torch.Tensor = 24.0
    A: float | torch.Tensor = 0.475
    L: float | torch.Tensor = DEADLINE_HOURS

    def cdf(self, t):
        return torch.clamp(self.cdf_raw(t), 0.0, 1.0)

    def cdf_raw(self, t):
        """Unclipped Eq. 1."""
        t = self._f64(t)
        return self.A * (1.0 - _exp(-t / self.tau1)
                         + _exp((t - self.b) / self.tau2))

    def pdf(self, t):
        """Eq. 2: f(t) = A * (e^{-t/tau1}/tau1 + e^{(t-b)/tau2}/tau2)."""
        t = self._f64(t)
        return self.A * (_exp(-t / self.tau1) / self.tau1
                         + _exp((t - self.b) / self.tau2) / self.tau2)

    def hazard(self, t):
        """Eq. 5 with r1 = 1/tau1, r2 = 1/tau2."""
        t = self._f64(t)
        r1, r2 = 1.0 / self.tau1, 1.0 / self.tau2
        num = r1 * _exp(-r1 * t) + r2 * _exp(r2 * (t - self.b))
        den = 1.0 / self.A - 1.0 + _exp(-r1 * t) - _exp(r2 * (t - self.b))
        return num / torch.clamp(den, min=1e-12)

    def _antiderivative(self, t):
        """G(t) = A[-(t+tau1)e^{-t/tau1} + (t-tau2)e^{(t-b)/tau2}]."""
        return self.A * (-(t + self.tau1) * _exp(-t / self.tau1)
                         + (t - self.tau2) * _exp((t - self.b) / self.tau2))

    def partial_expectation(self, a, b):
        return (self._antiderivative(self._f64(b))
                - self._antiderivative(self._f64(a)))

    def phases(self):
        """Approximate phase boundaries (initial | stable | deadline): the
        initial process has decayed by ~3*tau1; the deadline process
        activates where its pdf term reaches the stable-phase floor at
        t1.  Returns ``(t1, t2)`` tensors, ``t2`` clipped to [t1, L]."""
        t1 = 3.0 * self._f64(self.tau1)
        floor = self.pdf(t1)
        t2 = self.b + self.tau2 * torch.log(
            torch.clamp(floor * self.tau2 / self.A, min=1e-12))
        return t1, _clip(t2, t1, self._f64(self.L))

    def icdf(self, u):
        """Invert Eq. 1: 12 bracketing halvings, then 6 safeguarded Newton
        steps (the bracket keeps shrinking, an overshoot is clipped back
        into it, and an iterate on the clipped plateau F_raw > 1 takes the
        bracket midpoint instead)."""
        u = self._f64(u)
        lo = torch.zeros_like(u)
        hi = torch.broadcast_to(self._f64(self.L), u.shape)
        for _ in range(12):
            mid = 0.5 * (lo + hi)
            below = self.cdf(mid) < u
            lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
        t = 0.5 * (lo + hi)
        for _ in range(6):
            # Eq. 1 cdf and Eq. 2 pdf share their two exponentials
            e1 = _exp(-t / self.tau1)
            e2 = _exp((t - self.b) / self.tau2)
            F_raw = self.A * (1.0 - e1 + e2)
            F = torch.clamp(F_raw, 0.0, 1.0)
            below = F < u
            lo = torch.where(below, t, lo)
            hi = torch.where(below, hi, t)
            pdf = self.A * (e1 / self.tau1 + e2 / self.tau2)
            tn = _clip(t - (F - u) / torch.clamp(pdf, min=1e-30), lo, hi)
            t = torch.where(F_raw > 1.0, 0.5 * (lo + hi), tn)
        return t


def capped_constrained(base, *, A_scale, tau1_scale) -> Constrained:
    """Scale a Constrained-parameterized model's early phase (``A``,
    ``tau1``) while keeping the raw Eq. 1 CDF proper (<= 1) up to the
    deadline; the cap never pushes ``A`` below the base fit."""
    f64 = base._f64
    tau1 = torch.clamp(f64(base.tau1) * tau1_scale, min=0.05)
    cap = (1.0 - 1e-3) / (1.0 - _exp(-f64(base.L) / tau1)
                          + _exp((f64(base.L) - base.b) / base.tau2))
    A = _clip(f64(base.A) * A_scale, 1e-3, torch.maximum(cap, f64(base.A)))
    return Constrained(tau1=tau1, tau2=base.tau2, b=base.b, A=A, L=base.L)


@_dist
class DiurnalConstrained(_DistBase):
    """Obs. 5 launch-phase-modulated constrained model:

        m(c)     = cos(2*pi*(c - peak_clock) / 24)
        A_eff    = A    * (1 + amp_A    * m(launch_clock))
        tau1_eff = tau1 * (1 - amp_tau1 * m(launch_clock))

    with ``A_eff`` capped by :func:`capped_constrained`.  Every method
    delegates to the launch-resolved :meth:`effective` model."""

    tau1: float | torch.Tensor = 1.0
    tau2: float | torch.Tensor = 0.8
    b: float | torch.Tensor = 24.0
    A: float | torch.Tensor = 0.475
    launch_clock: float | torch.Tensor = 12.0
    amp_A: float | torch.Tensor = 0.15
    amp_tau1: float | torch.Tensor = 0.35
    peak_clock: float | torch.Tensor = 20.0
    L: float | torch.Tensor = DEADLINE_HOURS

    def modulation(self):
        """m(launch_clock) in [-1, 1]; +1 at the busiest launch hour."""
        return torch.cos(2.0 * math.pi
                         * (self._f64(self.launch_clock) - self.peak_clock)
                         / 24.0)

    def effective(self) -> Constrained:
        m = self.modulation()
        return capped_constrained(self, A_scale=1.0 + self.amp_A * m,
                                  tau1_scale=1.0 - self.amp_tau1 * m)

    def cdf(self, t):
        return self.effective().cdf(t)

    def cdf_raw(self, t):
        return self.effective().cdf_raw(t)

    def pdf(self, t):
        return self.effective().pdf(t)

    def hazard(self, t):
        return self.effective().hazard(t)

    def partial_expectation(self, a, b):
        return self.effective().partial_expectation(a, b)

    def icdf(self, u):
        return self.effective().icdf(u)

    def phases(self):
        return self.effective().phases()


@_dist
class Exponential(_DistBase):
    """Memoryless baseline: F(t) = 1 - e^{-t/mttf}."""

    mttf: float | torch.Tensor = 6.0
    L: float | torch.Tensor = DEADLINE_HOURS

    def cdf(self, t):
        return 1.0 - _exp(-self._f64(t) / self.mttf)

    def pdf(self, t):
        return _exp(-self._f64(t) / self.mttf) / self.mttf

    def hazard(self, t):
        return torch.broadcast_to(1.0 / self._f64(self.mttf),
                                  self._f64(t).shape)

    def partial_expectation(self, a, b):
        def g(t):
            return -(t + self.mttf) * _exp(-t / self.mttf)
        return g(self._f64(b)) - g(self._f64(a))


@_dist
class Weibull(_DistBase):
    """F(t) = 1 - exp(-(lam*t)^k)."""

    lam: float | torch.Tensor = 0.15
    k: float | torch.Tensor = 0.9
    L: float | torch.Tensor = DEADLINE_HOURS

    def _z(self, t):
        return torch.clamp(self.lam * self._f64(t), min=1e-12)

    def cdf(self, t):
        return 1.0 - _exp(-torch.pow(self._z(t), self.k))

    def pdf(self, t):
        z = self._z(t)
        return (self.lam * self.k * torch.pow(z, self.k - 1.0)
                * _exp(-torch.pow(z, self.k)))

    def hazard(self, t):
        return self.lam * self.k * torch.pow(self._z(t), self.k - 1.0)


@_dist
class GompertzMakeham(_DistBase):
    """F(t) = 1 - exp(-lam*t - (alpha/beta)(e^{beta t} - 1)); hazard
    lam + alpha e^{beta t}."""

    lam: float | torch.Tensor = 0.08
    alpha: float | torch.Tensor = 1e-4
    beta: float | torch.Tensor = 0.35
    L: float | torch.Tensor = DEADLINE_HOURS

    def cdf(self, t):
        t = self._f64(t)
        return 1.0 - _exp(-self.lam * t - (self.alpha / self.beta)
                          * (_exp(self.beta * t) - 1.0))

    def pdf(self, t):
        return self.hazard(t) * self.survival(t)

    def hazard(self, t):
        return self.lam + self.alpha * _exp(self.beta * self._f64(t))


@_dist
class Uniform(_DistBase):
    """Uniformly distributed constrained preemptions: F(t) = t / L (the
    paper's Fig. 5 comparison)."""

    L: float | torch.Tensor = DEADLINE_HOURS

    def cdf(self, t):
        return torch.clamp(self._f64(t) / self.L, 0.0, 1.0)

    def pdf(self, t):
        t = self._f64(t)
        inside = (t >= 0) & (t <= self.L)
        return torch.where(inside, 1.0 / self._f64(self.L), 0.0)

    def partial_expectation(self, a, b):
        L = self._f64(self.L)
        a_ = _clip(self._f64(a), 0.0, L)
        b_ = _clip(self._f64(b), 0.0, L)
        return (b_ * b_ - a_ * a_) / (2.0 * L)


def _interp(x, xp, fp, left=None, right=None):
    """``jnp.interp`` for increasing knots ``xp``: linear between the knots,
    ``left`` below ``xp[0]`` and ``right`` above ``xp[-1]`` (``fp``'s end
    values when None); a knot interval of width at most ``spacing(eps)``
    of the knots' dtype (a duplicated knot) takes the value at its left
    end.  ``xp`` / ``fp`` are ``(G,)`` (any ``x``) or rows ``(B, G)``
    (``x`` ``(B, n)``), one interpolant per row."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[-1] - 1)
    if xp.ndim == 1:
        take = lambda a, k: a[k]                          # noqa: E731
    else:
        take = lambda a, k: torch.gather(a, -1, k)        # noqa: E731
    x0, f0 = take(xp, i - 1), take(fp, i - 1)
    dx = take(xp, i) - x0
    tiny = np.spacing(np.finfo(str(xp.dtype).split(".")[-1]).eps)
    dx0 = torch.abs(dx) <= float(tiny)
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx))
                    * (take(fp, i) - f0))
    lo = fp[..., :1] if left is None else torch.as_tensor(
        left, dtype=f.dtype, device=f.device)
    hi = fp[..., -1:] if right is None else torch.as_tensor(
        right, dtype=f.dtype, device=f.device)
    f = torch.where(x < xp[..., :1], lo, f)
    return torch.where(x > xp[..., -1:], hi, f)


@_dist
class Empirical(_DistBase):
    """Interpolated CDF of an observed lifetime trace: ``knots`` the sorted
    lifetimes ``(n,)``, ``values`` the ECDF there (midpoint convention
    ``(i + 0.5) / n``)."""

    knots: torch.Tensor
    values: torch.Tensor
    L: float | torch.Tensor = DEADLINE_HOURS

    @staticmethod
    def from_samples(samples, L=DEADLINE_HOURS) -> "Empirical":
        """From a trace: an array (on the CPU) or a tensor (on its
        device)."""
        s = torch.as_tensor(samples, dtype=_F64).reshape(-1)
        s = torch.sort(s).values
        n = s.shape[0]
        v = (torch.arange(n, dtype=_F64, device=s.device) + 0.5) / n
        return Empirical(knots=s, values=v,
                         L=torch.as_tensor(L, dtype=_F64, device=s.device))

    def cdf(self, t):
        return _interp(self._f64(t), self.knots, self.values, 0.0, 1.0)

    def pdf(self, t):
        """Finite-difference density (diagnostics only)."""
        eps = 0.05
        t = self._f64(t)
        return (self.cdf(t + eps) - self.cdf(t - eps)) / (2 * eps)

    def quantile(self, q):
        return _interp(self._f64(q), self.values, self.knots, 0.0,
                      self._f64(self.L))


# The paper's typical fit: tau1 in [0.5, 1.5] h, tau2 ~ 0.8 h, b ~ 24 h, A in
# [0.4, 0.5]; n1-highcpu-16 / us-east1-b is the Fig. 1 headline config.
PAPER_FIT_N1_HIGHCPU_16 = dict(tau1=1.0, tau2=0.8, b=24.0, A=0.475)

VM_TYPE_PARAMS = {
    # name                tau1   tau2    b     A     (Obs. 4: larger => faster)
    "n1-highcpu-2": dict(tau1=1.5, tau2=0.85, b=24.0, A=0.40),
    "n1-highcpu-4": dict(tau1=1.3, tau2=0.85, b=24.0, A=0.42),
    "n1-highcpu-8": dict(tau1=1.1, tau2=0.80, b=24.0, A=0.44),
    "n1-highcpu-16": dict(tau1=1.0, tau2=0.80, b=24.0, A=0.475),
    "n1-highcpu-32": dict(tau1=0.6, tau2=0.75, b=24.0, A=0.50),
    # TPU-fleet analogue used by the training framework (pod-granular)
    "tpu-v5e-pod": dict(tau1=1.0, tau2=0.80, b=24.0, A=0.475),
}


def registry():
    """Family name -> class, for the families this package ports."""
    return {
        "constrained": Constrained,
        "diurnal_constrained": DiurnalConstrained,
        "exponential": Exponential,
        "weibull": Weibull,
        "gompertz_makeham": GompertzMakeham,
        "uniform": Uniform,
        "empirical": Empirical,
    }


def stack(dists, device=None):
    """One distribution of the shared family whose fields are float64
    ``(S,)`` tensors, on ``device`` (default: the first entry's device, or
    the CPU for a dataclass without one, such as ``market.PriceProcess``)."""
    dists = list(dists)
    if not dists:
        raise ValueError("stack() needs at least one distribution")
    cls = type(dists[0])
    if any(type(d) is not cls for d in dists[1:]):
        raise TypeError("stack() requires one distribution family, got "
                        f"{sorted({type(d).__name__ for d in dists})}")
    dev = getattr(dists[0], "device", None) if device is None else device
    return cls(**{
        f.name: torch.stack([torch.as_tensor(getattr(d, f.name), dtype=_F64,
                                             device=dev) for d in dists])
        for f in dataclasses.fields(cls)})


def unstack(dist):
    """Invert :func:`stack`: a list of per-scenario distributions."""
    fields = dataclasses.fields(dist)
    lead = getattr(dist, fields[0].name)
    if not isinstance(lead, torch.Tensor) or lead.ndim == 0:
        raise ValueError("unstack() expects a stacked distribution with a "
                         "leading scenario axis")
    return [dataclasses.replace(dist, **{f.name: getattr(dist, f.name)[i]
                                         for f in fields})
            for i in range(lead.shape[0])]


def constrained_for(vm_type: str = "n1-highcpu-16") -> Constrained:
    return Constrained(**VM_TYPE_PARAMS[vm_type])


def diurnal_for(vm_type: str = "n1-highcpu-16",
                launch_clock: float = 12.0, **kw) -> DiurnalConstrained:
    """The type's paper-calibrated Eq. 1 fit, modulated by the wall-clock
    launch hour; ``kw`` overrides any field."""
    return DiurnalConstrained(**{**VM_TYPE_PARAMS[vm_type],
                                 "launch_clock": launch_clock, **kw})
