"""Young-Daly periodic checkpointing - the memoryless baseline: checkpoint
every tau = sqrt(2 * delta * MTTF), with the MTTF implied by the VM's
initial failure rate (the paper's Fig. 7 setup)."""
from __future__ import annotations

import torch


def interval(delta, mttf):
    """tau = sqrt(2 * delta * MTTF) (hours)."""
    return torch.sqrt(2.0 * torch.as_tensor(delta, dtype=torch.float64)
                      * mttf)


def mttf_from_initial_rate(dist):
    """MTTF implied by the hazard at t=0."""
    return 1.0 / float(dist.hazard(1e-3))
