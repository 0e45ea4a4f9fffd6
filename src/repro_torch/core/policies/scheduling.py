"""Model-driven job scheduling and VM-reuse policy (paper Eqs. 6-10,
Figs. 5-6), in PyTorch.

Port of ``repro.core.policies.scheduling``: every function takes a
distribution from ``repro_torch.core.distributions`` and broadcasts over
``T`` (job length) and ``s`` (VM age at job start), in float64 on the
distribution's device.  The reuse decision drives the serving path's
admission and the batch service's hot-spare policy; the failure
probabilities are the Fig. 5/6 quantities behind the paper's "more than 2x
lower job failure probability".

The provider's hard 24 h cap means a VM alive at age s is certainly gone
by L, so the capped CDF is F~(t) = 1 for t >= L.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-9


def _f64(dist, x):
    return torch.as_tensor(x, dtype=torch.float64, device=dist.device)


def linspace(start: float, stop: float, num: int,
             dtype=np.float64) -> np.ndarray:
    """``num`` points of ``dtype`` (float64 by default) from ``start`` to
    ``stop`` inclusive, the last point ``stop`` exactly, in the expression
    tree of compiled ``jnp.linspace`` (under x64 for float64):
    ``start * (1 - i * r) + i * (stop * r)`` with ``r = 1 / (num - 1)``
    rounded once (XLA turns the division of the iota by ``num - 1`` into a
    product with ``r`` and reassociates ``(i * r) * stop`` into
    ``i * (stop * r)``), every operation rounded in ``dtype``.

    At ``start = 0`` (every caller here) the first product is an exact
    zero, so each point is ``i * (stop * r)`` whether or not the backend
    fuses the sum into an FMA, and the grid equals ``jnp.linspace``'s to
    the bit.  At ``start != 0`` XLA:CPU fuses ``1 - i*r`` and the sum into
    FMAs in its vector loop but not in its unrolled or remainder code, so
    which of them rounds once depends on ``num``; numpy rounds every
    operation, which puts a point at most one ulp from XLA's."""
    f = np.dtype(dtype).type
    div = num - 1
    if div < 1:
        return np.full((max(num, 0),), f(start))
    r = f(1.0) / f(div)
    i = np.arange(div, dtype=f)
    out = f(start) * (f(1.0) - i * r) + i * (f(stop) * r)
    return np.concatenate([out, [f(stop)]])


def capped_cdf(dist, t):
    """F~(t): the model CDF with the deterministic deadline mass at L."""
    t = _f64(dist, t)
    return torch.where(t >= dist.L, 1.0, dist.cdf(t))


def expected_wasted_work(dist, T):
    """Eq. 7: E[W1(T)] = (1/F(T)) * integral_0^T t f(t) dt, the expected
    work lost to a single preemption during a length-T job on a fresh
    VM."""
    T = _f64(dist, T)
    return dist.partial_expectation(0.0, T) / torch.clamp(dist.cdf(T),
                                                          min=_EPS)


def expected_makespan_new(dist, T):
    """Eq. 9: E[T] = T + integral_0^T t f(t) dt (single-failure model,
    fresh VM)."""
    T = _f64(dist, T)
    return T + dist.partial_expectation(0.0, T)


def expected_makespan_at_age(dist, T, s):
    """Eq. 10: E[T_s] = T + integral_s^{s+T} t f(t) dt, job started at VM
    age s; +inf where the job's window crosses the deadline L."""
    T, s = _f64(dist, T), _f64(dist, s)
    m = T + dist.partial_expectation(s, s + T)
    return torch.where(s + T >= dist.L, math.inf, m)


def p_fail_existing_paper(dist, T, s):
    """The paper's printed P_Existing = max(1, F(T+s) - F(T)), kept as
    printed (the 'max' and 'F(T)' read as typos); :func:`p_fail_existing`
    is the corrected conditional form."""
    T = _f64(dist, T)
    return torch.clamp(dist.cdf(T + _f64(dist, s)) - dist.cdf(T), min=1.0)


def p_fail_existing(dist, T, s):
    """P(preempted during (s, s+T] | alive at s), with the hard-cap rule:
    windows crossing L always fail."""
    T, s = _f64(dist, T), _f64(dist, s)
    num = capped_cdf(dist, s + T) - capped_cdf(dist, s)
    den = torch.clamp(1.0 - capped_cdf(dist, s), min=_EPS)
    return torch.clamp(torch.where(s + T >= dist.L, 1.0, num / den),
                       0.0, 1.0)


def p_fail_new(dist, T):
    """Failure probability of a length-T job on a freshly launched VM."""
    return torch.clamp(capped_cdf(dist, _f64(dist, T)), 0.0, 1.0)


def reuse_decision(dist, T, s, relaunch_overhead=0.0):
    """True -> run on the existing (age-s) VM; False -> relinquish it and
    launch a new one: the lower of Eq. 10 and Eq. 9 wins.
    ``relaunch_overhead`` (hours) charges the fresh VM its provisioning
    time (0.0 keeps the paper's criterion)."""
    return expected_makespan_at_age(dist, T, s) < \
        expected_makespan_new(dist, T) + relaunch_overhead


def job_failure_prob_memoryless(dist, T, s):
    """Baseline (SpotOn-style): always reuse the running VM (Fig. 6a
    grey)."""
    return p_fail_existing(dist, T, s)


def job_failure_prob_policy(dist, T, s):
    """The paper's policy (Fig. 6a): failure probability after the reuse
    decision."""
    reuse = reuse_decision(dist, T, s)
    return torch.where(reuse, p_fail_existing(dist, T, s),
                       p_fail_new(dist, T))


def mean_failure_prob_over_starts(dist, T, n_starts: int = 241,
                                  policy: bool = True):
    """Fig. 6b: failure probability averaged over job start ages s in
    [0, L)."""
    T = _f64(dist, T)
    s = _f64(dist, linspace(0.0, float(dist.L) * (1.0 - 1e-3), n_starts))
    fn = job_failure_prob_policy if policy else job_failure_prob_memoryless
    return torch.mean(fn(dist, T[..., None], s), dim=-1)


def expected_runtime_increase(dist, T):
    """Fig. 5b: P(failure) * E[W1(T)] = integral_0^T t f(t) dt, the
    expected increase in running time of a length-T job (single-failure
    model)."""
    return dist.partial_expectation(0.0, _f64(dist, T))
