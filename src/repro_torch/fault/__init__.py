"""Fault tolerance: the simulated provider preemption signal."""
from .preemption import PreemptionSource

__all__ = ["PreemptionSource"]
