"""Model-based optimal checkpointing via dynamic programming (Eqs. 11-15).

Port of ``repro.core.policies.checkpointing``.  A job of J steps, each one
grid unit ``grid_dt`` (hours), with a checkpoint costing ``delta_steps``
grid units:

    V[j, t] = min_{1<=i<=j}  P_succ(t, w) * ( w*dt + V[j-i, t+w] )
                           + P_fail(t, w) * ( E_lost(t, w) + R_j )

where w = i + delta (no trailing checkpoint on the final segment, i == j),
``t`` is the VM age index and R_j the cost of restarting the j remaining
steps on a fresh VM (relaunch overhead + V[j, 0], fixed-pointed over
``n_sweeps`` sweeps).  The dollar objective prices the same recurrence
against a cumulative-dollar grid (see :func:`solve_batch`).

The tables are float32 ``V`` and int32 ``K`` tensors on the solve's device;
the recurrence itself runs in a backend of ``solver_backends``.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Sequence

import numpy as np
import torch

from ...device import resolve_device
from . import solver_backends
from .solver_backends.grids import cdf_grids, price_cum_grids

OBJECTIVES = ("makespan", "dollars")


@dataclasses.dataclass(frozen=True)
class DPTables:
    """Solved DP: V[j, t] expected remaining cost-to-completion, K[j, t]
    optimal next-checkpoint interval (steps).  ``objective`` records the
    unit of V: hours (``"makespan"``) or dollars (``"dollars"``)."""
    V: torch.Tensor
    K: torch.Tensor
    grid_dt: float
    delta_steps: int
    restart_overhead: float
    horizon_idx: int
    objective: str = "makespan"

    def interval_steps(self, remaining_steps: int, age_idx: int) -> int:
        j = int(np.clip(remaining_steps, 0, self.K.shape[0] - 1))
        t = int(np.clip(age_idx, 0, self.K.shape[1] - 1))
        return int(self.K[j, t])

    def expected_makespan(self, job_steps: int, age_idx: int = 0) -> float:
        """V at (job_steps, age_idx): hours, or dollars for the dollar
        objective."""
        return float(self.V[int(job_steps), int(age_idx)])


@dataclasses.dataclass(frozen=True)
class BatchDPTables:
    """Solved DP for a scenario batch: V/K carry a leading ``(S,)`` axis.
    ``tables(s)`` returns the per-scenario :class:`DPTables` view."""
    V: torch.Tensor              # (S, j_max+1, t_max+1) float32
    K: torch.Tensor              # (S, j_max+1, t_max+1) int32
    grid_dt: float
    delta_steps: int
    restart_overhead: float
    horizon_idx: int
    backend: str = "reference"   # provenance, not part of table identity
    objective: str = "makespan"

    def __len__(self) -> int:
        return self.V.shape[0]

    def tables(self, s: int) -> DPTables:
        return DPTables(V=self.V[s], K=self.K[s], grid_dt=self.grid_dt,
                        delta_steps=self.delta_steps,
                        restart_overhead=self.restart_overhead,
                        horizon_idx=self.horizon_idx,
                        objective=self.objective)

    def expected_makespan(self, s: int, job_steps: int,
                          age_idx: int = 0) -> float:
        """V at (s, job_steps, age_idx)."""
        return float(self.V[int(s), int(job_steps), int(age_idx)])

    def validate(self) -> "BatchDPTables":
        """Reject half-written or diverged tables: every V finite and
        non-negative, ``0 <= K[j] <= j`` and ``K[j] >= 1`` for ``j >= 1``.
        Raises ``ValueError``; returns ``self`` so calls chain."""
        unit = "dollars" if self.objective == "dollars" else "makespans"
        if not bool(torch.isfinite(self.V).all()):
            raise ValueError(
                f"BatchDPTables.validate: non-finite V entries ({unit})")
        if bool((self.V < 0.0).any()):
            raise ValueError(f"BatchDPTables.validate: negative {unit} in V")
        j = torch.arange(self.K.shape[1], device=self.K.device)[None, :, None]
        if bool((self.K < 0).any()) or bool((self.K > j).any()):
            raise ValueError("BatchDPTables.validate: K outside [0, j]")
        if bool((self.K[:, 1:, :] < 1).any()):
            raise ValueError("BatchDPTables.validate: K < 1 with work "
                             "remaining (j >= 1)")
        return self


def _check_objective(objective: str, price) -> None:
    if objective not in OBJECTIVES:
        raise ValueError(f"objective={objective!r}; expected one of "
                         f"{OBJECTIVES}")
    if objective == "dollars" and price is None:
        raise ValueError("objective='dollars' requires price= (a price grid "
                         "with prices, cum and dt)")
    if objective == "makespan" and price is not None:
        raise ValueError("price= is only meaningful with objective='dollars'")


def _dollar_inputs(price, grid_dt: float, t_max: int, job_steps: int,
                   delta_steps: int, restart_overhead: float, S: int, device):
    """The float32 cumulative-dollar grid ``Pc`` ``(S, TX)`` and the
    per-scenario dollar restart overhead ``ro`` ``(S,)`` (overhead hours
    billed at the launch-cell price), on ``device``.  ``price`` is duck
    typed (``prices``, ``cum``, ``dt``); one row broadcasts over S."""
    rows = np.asarray(price.prices).shape[0]
    if rows not in (1, S):
        raise ValueError(
            f"price= has {rows} rows; expected 1 (broadcast) or S={S}")
    Pc, P0 = price_cum_grids(price.prices, price.cum, price.dt, grid_dt,
                             t_max, int(job_steps) + int(delta_steps))
    if rows == 1 and S > 1:
        Pc = np.broadcast_to(Pc, (S,) + Pc.shape[1:])
        P0 = np.broadcast_to(P0, (S,))
    ro = (float(restart_overhead) * P0).astype(np.float32)
    return (torch.as_tensor(np.ascontiguousarray(Pc), device=device),
            torch.as_tensor(ro, device=device))


def solve_batch(dists: Sequence, job_steps: int, *,
                grid_dt: float = 1.0 / 60.0, delta_steps: int = 1,
                n_sweeps: int = 3, restart_overhead: float = 0.0, v_init=None,
                backend: str = "auto", objective: str = "makespan",
                price=None, device="cuda") -> BatchDPTables:
    """Solve the checkpointing DP for a scenario batch sharing one deadline.

    ``backend`` is ``"auto"`` (the CUDA kernel on a CUDA device, the plain
    recurrence otherwise), ``"reference"`` or ``"cuda"``.  ``v_init``
    warm-starts the restart-cost fixed point from a previous solve's
    ``(S, j_max+1, t_max+1)`` V of the same objective.

    ``objective="dollars"`` with ``price=`` (``prices``/``cum``/``dt`` of a
    price grid; one row broadcasts, otherwise one row per scenario) makes V
    the expected dollars-to-completion:

        V[j, t] = min_i  P_succ * ( dP(t, w) + V[j-i, t+w] )
                       + P_fail * ( E_lost * dP(t, w) / (w*dt) + R_j )

    with ``dP(t, w) = Pc(t+w) - Pc(t)`` and ``R_j = restart_overhead x
    launch price + V[j, 0]``.
    """
    dev = resolve_device(device)
    _check_objective(objective, price)
    dists = list(dists)
    if not dists:
        raise ValueError("solve_batch() needs at least one distribution")
    L = float(dists[0].L)
    if any(abs(float(d.L) - L) > 1e-12 for d in dists[1:]):
        raise ValueError("solve_batch() requires a shared deadline L")
    t_max = int(round(L / grid_dt))
    if v_init is not None:
        want = (len(dists), int(job_steps) + 1, t_max + 1)
        v_init = torch.as_tensor(v_init)
        if tuple(v_init.shape) != want:
            raise ValueError(
                f"solve_batch(v_init=...): shape {tuple(v_init.shape)} does "
                f"not match this solve's tables {want}; warm starts require "
                f"the same scenario count, job_steps and grid")
        if not bool(torch.isfinite(v_init).all()):
            raise ValueError("solve_batch(v_init=...): non-finite warm start")
        v_init = v_init.to(device=dev, dtype=torch.float32)
    grids = [cdf_grids(d, grid_dt, dev) for d in dists]
    Fc = torch.stack([g[0] for g in grids])
    Hc = torch.stack([g[1] for g in grids])
    Pc, ro = None, restart_overhead
    if objective == "dollars":
        Pc, ro = _dollar_inputs(price, grid_dt, t_max, job_steps, delta_steps,
                                restart_overhead, len(dists), dev)
    name = solver_backends.resolve(backend, dev)
    V, K = solver_backends.get(name).solve_tables_batch(
        Fc, Hc, grid_dt, ro, v_init, Pc, j_max=int(job_steps), t_max=t_max,
        delta_steps=int(delta_steps), n_sweeps=n_sweeps)
    return BatchDPTables(V=V, K=K, grid_dt=grid_dt,
                         delta_steps=int(delta_steps),
                         restart_overhead=restart_overhead, horizon_idx=t_max,
                         backend=name, objective=objective)


def solve(dist, job_steps: int, *, grid_dt: float = 1.0 / 60.0,
          delta_steps: int = 1, n_sweeps: int = 3,
          restart_overhead: float = 0.0, backend: str = "auto",
          objective: str = "makespan", price=None,
          device="cuda") -> DPTables:
    """Solve the DP for one distribution: :func:`solve_batch` at S = 1
    (row 0 of a multi-row price grid)."""
    if price is not None:
        price = types.SimpleNamespace(prices=np.asarray(price.prices)[:1],
                                      cum=np.asarray(price.cum)[:1],
                                      dt=price.dt)
    return solve_batch([dist], job_steps, grid_dt=grid_dt,
                       delta_steps=delta_steps, n_sweeps=n_sweeps,
                       restart_overhead=restart_overhead, backend=backend,
                       objective=objective, price=price,
                       device=device).tables(0)


def extract_schedule(tables: DPTables, job_steps: int,
                     start_age_idx: int = 0) -> list[int]:
    """Planned checkpoint intervals (steps) assuming no failures - the
    paper's i1, i2, ... sequence."""
    out, j, t = [], int(job_steps), int(start_age_idx)
    while j > 0:
        i = tables.interval_steps(j, t)
        i = max(1, min(i, j))
        out.append(i)
        j -= i
        t = min(t + i + (tables.delta_steps if j > 0 else 0),
                tables.horizon_idx)
    return out
