"""Model-driven VM-reuse policy (paper Eqs. 9-10, Fig. 6), in PyTorch.

Port of the part of ``repro.core.policies.scheduling`` that the serving
path's admission uses: every function takes a distribution from
``repro_torch.core.distributions`` and broadcasts over ``T`` (job length)
and ``s`` (VM age at job start), in float64 on the distribution's device.

The provider's hard 24 h cap means a VM alive at age s is certainly gone
by L, so the capped CDF is F~(t) = 1 for t >= L.
"""
from __future__ import annotations

import math

import torch


def _f64(dist, x):
    return torch.as_tensor(x, dtype=torch.float64, device=dist.device)


def capped_cdf(dist, t):
    """F~(t): the model CDF with the deterministic deadline mass at L."""
    t = _f64(dist, t)
    return torch.where(t >= dist.L, 1.0, dist.cdf(t))


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


def reuse_decision(dist, T, s, relaunch_overhead=0.0):
    """True -> run on the existing (age-s) VM; False -> relinquish it and
    launch a new one: the lower of Eq. 10 and Eq. 9 wins.
    ``relaunch_overhead`` (hours) charges the fresh VM its provisioning
    time (0.0 keeps the paper's criterion)."""
    return expected_makespan_at_age(dist, T, s) < \
        expected_makespan_new(dist, T) + relaunch_overhead
