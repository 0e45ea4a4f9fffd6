"""Fault tolerance: the simulated provider preemption signal and the
deterministic fault injector of the closed-loop runtime."""
from .injection import FaultEvent, FaultInjector, default_schedule
from .preemption import PreemptionSource

__all__ = ["FaultEvent", "FaultInjector", "PreemptionSource",
           "default_schedule"]
