"""Synthetic preemption traces for constrained transient VMs (port of
``repro.core.simulator``).

The paper's 1,516-preemption trace is not public, so the closed loop and
its tests draw lifetimes from a *ground-truth hazard process* with the
phenomenology of Figs. 1-2 (steep early preemptions, a long stable phase,
the deadline wall, the hard 24 h cap, diurnal and VM-size modulation):

    lambda(t) = h0 exp(-t / d0) + h_s diurnal(clock) + k / (L - t + s)^4

a different family from Eq. 1, so that "the model fits better than
exponential/Weibull/GM" is a statement about model capacity.

Sampling inverts a 4,096-point cumulative-hazard grid.  Computation runs
in ``dtype`` on the device of the query, the uniforms or the generator.
float32 is what the runtime uses (``repro`` computes so with x64 off);
float64 exists only to mirror ``repro``'s x64 mode in the parity tests,
and nothing else should come to depend on it.  Draws take a
``torch.Generator``; :meth:`GroundTruth.from_uniforms` maps given uniforms
to lifetimes, so two implementations can be fed the same draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .distributions import DEADLINE_HOURS, _interp
from .policies.scheduling import linspace

_GRID_N = 4096

# Cumulative-hazard grids depend only on the process parameters, the dtype
# and the device, so scalar GroundTruth instances share them here.
_GRID_CACHE: dict = {}
_GRID_CACHE_MAX = 128

# The uniforms' range: lifetimes stay in (0, L].
_U_MIN, _U_MAX = 1e-6, 1.0 - 1e-9

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def uniform(generator: torch.Generator, shape, *, low: float = 0.0,
            high: float = 1.0, dtype=torch.float32):
    """Uniforms in ``[low, high)`` from ``generator``, on its device."""
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    return torch.clamp(u * (high - low) + low, min=low)


@dataclasses.dataclass(frozen=True, eq=False)
class GroundTruth:
    """Ground-truth constrained-preemption process (NOT the paper's
    model).  Fields are Python floats, or ``dtype`` tensors broadcasting
    against the time axis (one process per row)."""

    h0: float | torch.Tensor = 0.45         # initial-phase amplitude (1/h)
    d0: float | torch.Tensor = 1.4          # initial-phase decay (h)
    h_stable: float | torch.Tensor = 0.008  # stable-phase hazard floor (1/h)
    k_wall: float | torch.Tensor = 2.0      # deadline-wall strength
    s_wall: float | torch.Tensor = 0.6      # deadline-wall softening (h)
    diurnal_amp: float | torch.Tensor = 0.5   # Obs. 5: day/night swing
    launch_clock: float | torch.Tensor = 12.0  # hour of day at launch
    L: float = DEADLINE_HOURS
    dtype: torch.dtype = torch.float32

    def _on(self, x, device):
        """``x`` in ``dtype``: a tensor stays on its device, anything else
        goes to ``device``."""
        if isinstance(x, torch.Tensor):
            return x.to(self.dtype)
        return torch.as_tensor(x, dtype=self.dtype,
                               device=resolve_device(device))

    def hazard(self, t, device="cuda"):
        """The hazard at ages ``t`` (hours), on ``t``'s device if it is a
        tensor, else on ``device``."""
        t = self._on(t, device)
        clock = self.launch_clock + t
        # day (8-20h) busier than night: smooth +-amp modulation
        diurnal = 1.0 + self.diurnal_amp * torch.sin(
            2.0 * math.pi * (clock - 14.0) / 24.0)
        gap = self.L - torch.minimum(t, self._on(self.L - 1e-3, t.device)) \
            + self.s_wall
        wall = self.k_wall / torch.square(torch.square(gap))
        return self.h0 * torch.exp(-t / self.d0) + self.h_stable * diurnal \
            + wall

    def _grid_compute(self, device):
        t = torch.as_tensor(linspace(0.0, float(self.L), _GRID_N,
                                     dtype=_NP[self.dtype]), device=device)
        dt = t[1] - t[0]
        lam = self.hazard(t)
        steps = torch.cumsum(0.5 * (lam[..., 1:] + lam[..., :-1]) * dt, -1)
        cum = torch.cat([torch.zeros_like(lam[..., :1]), steps], -1)
        return t, 1.0 - torch.exp(-cum)          # the grid CDF

    def _grid(self, device):
        """The age grid ``(G,)`` and its CDF (``(G,)``, or ``(B, G)`` for
        tensor fields), cached for scalar processes."""
        vals = [getattr(self, f.name) for f in dataclasses.fields(self)]
        if any(isinstance(v, torch.Tensor) for v in vals):
            return self._grid_compute(device)
        key = (str(torch.device(device)),) + tuple(map(str, vals))
        hit = _GRID_CACHE.get(key)
        if hit is None:
            if len(_GRID_CACHE) >= _GRID_CACHE_MAX:
                _GRID_CACHE.pop(next(iter(_GRID_CACHE)))
            hit = _GRID_CACHE[key] = self._grid_compute(device)
        return hit

    def cdf(self, x, device="cuda"):
        """The process CDF at ``x`` (hours; ``(B, n)`` rows for tensor
        fields), interpolated on the grid; on ``x``'s device if it is a
        tensor, else on ``device``."""
        x = self._on(x, device)
        t, F = self._grid(x.device)
        return _interp(x, t.expand_as(F), F)

    def from_uniforms(self, u, device="cuda"):
        """Lifetimes in (0, L] from uniforms ``u`` (``(B, n)`` rows for
        tensor fields): the grid CDF inverted, survivors of the soft
        process reclaimed at exactly L (the provider's hard cap).  On
        ``u``'s device if it is a tensor, else on ``device``."""
        u = self._on(u, device)
        t, F = self._grid(u.device)
        last = F[..., -1:] if F.ndim > 1 else F[-1]
        x = _interp(torch.minimum(u, last - 1e-7), F, t.expand_as(F))
        return torch.where(u >= last, self._on(self.L, u.device), x)

    def sample(self, generator: torch.Generator, shape=()):
        """Lifetimes from ``generator``'s uniforms, on its device."""
        return self.from_uniforms(uniform(generator, shape, low=_U_MIN,
                                          high=_U_MAX, dtype=self.dtype))


# Ground-truth processes per VM type, consistent with Obs. 4 (larger VMs are
# preempted more) and calibrated so fitted Eq.-1 parameters land in the
# paper's quoted ranges (tau1 in [0.5,1.5], tau2~0.8, b~24, A in [0.4,0.5]).
_TYPE_SCALE = {
    "n1-highcpu-2": 0.55,
    "n1-highcpu-4": 0.70,
    "n1-highcpu-8": 0.85,
    "n1-highcpu-16": 1.00,
    "n1-highcpu-32": 1.45,
    "tpu-v5e-pod": 1.00,
}

FLEET_VM_TYPES = ("n1-highcpu-2", "n1-highcpu-4", "n1-highcpu-8",
                  "n1-highcpu-16", "n1-highcpu-32")


def ground_truth_for(vm_type: str = "n1-highcpu-16",
                     launch_clock: float = 12.0, idle: bool = False,
                     dtype=torch.float32) -> GroundTruth:
    scale = _TYPE_SCALE[vm_type]
    # Obs. 5: idle VMs live longer (lower stable hazard)
    h_stable = 0.008 * (0.5 if idle else 1.0)
    return GroundTruth(h0=0.45 * scale, h_stable=h_stable * scale,
                       launch_clock=launch_clock, dtype=dtype)


class FleetTrace(NamedTuple):
    """A fleet-wide synthetic preemption study (the paper's 1,516-VM
    study), tensors on the generator's device."""
    vm_type_idx: torch.Tensor   # (n,) int64 index into vm_types
    launch_clock: torch.Tensor  # (n,) wall-clock launch hour
    lifetime: torch.Tensor      # (n,) hours in (0, 24]


def generate_fleet_trace(generator: torch.Generator, n_vms: int = 1516,
                         vm_types=FLEET_VM_TYPES,
                         dtype=torch.float32) -> FleetTrace:
    """n_vms launches across VM types with launch hours spread over day and
    night, each VM's lifetime drawn from its own type's process at its own
    launch clock (one batched ``GroundTruth``, one grid per VM).  Draws
    come from ``generator`` in the order type, clock, lifetime uniform."""
    dev = generator.device
    type_idx = torch.randint(0, len(vm_types), (n_vms,), generator=generator,
                             device=dev)
    clock = uniform(generator, (n_vms,), high=24.0, dtype=dtype)
    u = uniform(generator, (n_vms,), low=_U_MIN, high=_U_MAX, dtype=dtype)
    # per-VM parameters in float64 first, as ground_truth_for's fields
    scale = np.asarray([_TYPE_SCALE[v] for v in vm_types],
                       np.float64)[type_idx.cpu().numpy()]
    col = lambda a: torch.as_tensor(a, device=dev).to(dtype)[:, None]  # noqa
    batched = GroundTruth(h0=col(0.45 * scale), h_stable=col(0.008 * scale),
                          launch_clock=clock[:, None], dtype=dtype)
    life = batched.from_uniforms(u[:, None])[:, 0]
    return FleetTrace(vm_type_idx=type_idx, launch_clock=clock, lifetime=life)


def trace_for(generator: torch.Generator, vm_type: str = "n1-highcpu-16",
              n: int = 300, launch_clock: float = 12.0, idle: bool = False,
              dtype=torch.float32):
    """Single-type lifetime trace (one CDF curve of Fig. 1 / Fig. 2)."""
    return ground_truth_for(vm_type, launch_clock, idle,
                            dtype).sample(generator, (n,))
