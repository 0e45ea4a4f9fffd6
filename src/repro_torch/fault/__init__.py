"""Fault tolerance: the simulated provider preemption signal, the straggler
watchdog, elastic re-meshing after pod loss and the deterministic fault
injector of the closed-loop runtime."""
from .injection import FaultEvent, FaultInjector, default_schedule
from .preemption import (ElasticPlan, PreemptionSource, StragglerWatchdog,
                         plan_elastic_remesh)

__all__ = ["ElasticPlan", "FaultEvent", "FaultInjector", "PreemptionSource",
           "StragglerWatchdog", "default_schedule", "plan_elastic_remesh"]
