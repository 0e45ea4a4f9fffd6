"""Fault tolerance: the simulated provider preemption signal, the straggler
watchdog and the deterministic fault injector of the closed-loop runtime."""
from .injection import FaultEvent, FaultInjector, default_schedule
from .preemption import PreemptionSource, StragglerWatchdog

__all__ = ["FaultEvent", "FaultInjector", "PreemptionSource",
           "StragglerWatchdog", "default_schedule"]
