"""Young-Daly periodic checkpointing - the memoryless baseline: checkpoint
every tau = sqrt(2 * delta * MTTF), with the MTTF implied by the VM's
initial failure rate (the paper's Fig. 7 setup)."""
from __future__ import annotations

import torch


def interval(delta, mttf):
    """tau = sqrt(2 * delta * MTTF) (hours)."""
    return torch.sqrt(2.0 * torch.as_tensor(delta, dtype=torch.float64)
                      * mttf)


def schedule(job_hours, delta, mttf):
    """Uniform checkpoint times (hours of work) for a job of given length."""
    tau = float(interval(delta, mttf))
    if tau <= 0:
        raise ValueError("non-positive Young-Daly interval")
    n = int(job_hours / tau)
    pts = [tau * (i + 1) for i in range(n)]
    return [p for p in pts if p < job_hours]


def mttf_from_initial_rate(dist):
    """MTTF implied by the hazard at t=0."""
    return 1.0 / float(dist.hazard(1e-3))


def expected_overhead(delta, mttf, restart_overhead: float = 0.0):
    """First-order expected running-time overhead fraction under the
    exponential-failure assumption Young-Daly itself makes:

        delta/tau  (checkpoint writes)  +  tau/(2*MTTF)  (mean recompute)
        +  restart_overhead/MTTF        (relaunch per failure)

    At MTTF = 1 h this is the paper's Fig. 7 "more than 25 %" model
    prediction; the bathtub's far lower stable-phase rate makes the
    simulated overhead smaller."""
    tau = float(interval(delta, mttf))
    return delta / tau + tau / (2.0 * mttf) + restart_overhead / mttf
