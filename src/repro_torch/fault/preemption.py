"""Pod-level fault tolerance: the preemption signal and the straggler
watchdog.

Port of ``repro.fault.preemption``'s ``PreemptionSource`` (lifetimes drawn
from the constrained-preemption model with the provider's 30 s advance
warning, and the paper's VM-reuse policy at pod granularity) and
``StragglerWatchdog``.  Lifetimes come from ``np.random.default_rng(seed)``
uniforms inverted by ``engine.capped_icdf_draw``, so one seed gives the JAX
package's lifetimes.  ``plan_elastic_remesh`` plans the survivors' mesh
after pods are lost (host arithmetic, as in ``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core import distributions, engine
from ..core.policies import scheduling as sched_policy
from ..device import resolve_device

WARNING_SECONDS = 30.0  # Google's advance notice


@dataclasses.dataclass
class PreemptionEvent:
    pod_id: int
    warning_at_hours: float
    preempt_at_hours: float


@dataclasses.dataclass
class PreemptionSource:
    """Simulated provider preemption signal for ``n_pods`` reservations.

    Times are simulated hours since the run's start; ``replace_pod`` draws
    a fresh lifetime (a relaunched reservation starts at age 0).  The
    lifetime draws and the reuse policy run on ``device``.
    """
    dist: object
    n_pods: int = 1
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        self._rng = np.random.default_rng(self.seed)
        self._dist = distributions.stack([self.dist], device=dev)
        self._dist = dataclasses.replace(self._dist, **{
            f.name: getattr(self._dist, f.name)[0]
            for f in dataclasses.fields(self._dist)})
        self._fl = self._dist.cdf(self._dist.L)
        self.launch_age = np.zeros(self.n_pods)       # run-clock at launch
        self.lifetimes = self._draw(self.n_pods)
        self.preempted = np.zeros(self.n_pods, bool)

    def _draw(self, n):
        u = torch.as_tensor(self._rng.uniform(size=n), device=self._dist.device)
        return engine.capped_icdf_draw(self._dist, u, self._fl,
                                       self._dist.L).cpu().numpy()

    def pod_age(self, pod_id: int, now_hours: float) -> float:
        return now_hours - self.launch_age[pod_id]

    def poll(self, now_hours: float) -> list[PreemptionEvent]:
        """Pods whose preemption lands within the warning window (or has
        passed).  Each pod reports once."""
        warn_h = WARNING_SECONDS / 3600.0
        out = []
        for i in range(self.n_pods):
            if self.preempted[i]:
                continue
            t_kill = self.launch_age[i] + self.lifetimes[i]
            if now_hours >= t_kill - warn_h:
                self.preempted[i] = True
                out.append(PreemptionEvent(i, max(t_kill - warn_h, 0.0),
                                           t_kill))
        return out

    def replace_pod(self, pod_id: int, now_hours: float):
        """Provision a replacement reservation (fresh lifetime, age 0)."""
        self.launch_age[pod_id] = now_hours
        self.lifetimes[pod_id] = self._draw(1)[0]
        self.preempted[pod_id] = False

    def reuse_decision(self, pod_id: int, job_hours: float,
                       now_hours: float,
                       relaunch_overhead: float = 5.0 / 60.0) -> bool:
        """The paper's VM-reuse policy at pod granularity: keep scheduling
        the next segment on this pod, or relinquish it for a fresh one.
        Pod provisioning is minutes, not seconds, so it is charged here."""
        if self.preempted[pod_id]:
            return False
        age = self.pod_age(pod_id, now_hours)
        return bool(sched_policy.reuse_decision(self._dist, job_hours, age,
                                                relaunch_overhead))


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Survivor topology after losing pods."""
    surviving_pods: tuple
    mesh_shape: tuple
    mesh_axes: tuple
    batch_scale: float          # global batch multiplier (survivors / total)
    reshard: bool               # params need re-sharding across survivors


def plan_elastic_remesh(n_pods: int, lost: Sequence[int], *,
                        pod_shape=(16, 16),
                        axes=("data", "model")) -> ElasticPlan:
    """Drop lost pods from the ``pod`` axis and continue on the survivors.

    Multi-pod training shards the batch over ("pod", "data") and keeps the
    parameters replicated across pods (or FSDP within a pod), so losing a
    pod means (a) shrinking the pod axis, (b) rescaling the global batch,
    (c) restoring the state from the last checkpoint on the survivors.
    With one survivor the mesh degenerates to the single-pod layout;
    losing every pod raises ``RuntimeError`` (the job must re-queue).
    """
    survivors = tuple(i for i in range(n_pods) if i not in set(lost))
    n = len(survivors)
    if n == 0:
        raise RuntimeError("all pods lost; job must re-queue")
    if n == 1:
        return ElasticPlan(survivors, pod_shape, axes, 1.0 / n_pods, False)
    return ElasticPlan(survivors, (n,) + tuple(pod_shape),
                       ("pod",) + tuple(axes), n / n_pods, False)


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags slow steps (failing hosts, thermal throttling) from step-time
    telemetry; the runbook response on a fleet is to demote the pod, which
    in this framework means treating it as a voluntary preemption."""
    threshold: float = 2.0      # x median
    window: int = 64

    def __post_init__(self):
        self._times: list[float] = []
        self.flagged = 0

    def observe(self, seconds: float) -> bool:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 8:
            return False
        med = float(np.median(self._times))
        if seconds > self.threshold * med:
            self.flagged += 1
            return True
        return False
