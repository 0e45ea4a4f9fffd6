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
from typing import Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from . import solver_backends
from .solver_backends import refine as refine_mod
from .solver_backends.grids import _EPS, cdf_grids, price_cum_grids

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
    refine_info: Optional[dict] = None   # refine=True's plan and outcome
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


def _sharded(fn, n_out: int, **operands):
    """``fn(**operands)`` through ``solver_backends.shard_scenarios``: under
    an active process group each tensor operand (every one carries the
    leading ``(S,)`` axis) is cut to this rank's scenarios and the
    ``n_out`` outputs are gathered; ``None`` and the makespan objective's
    float overhead pass through."""
    names = [k for k, v in operands.items() if isinstance(v, torch.Tensor)]

    def kern(*xs):
        return fn(**{**operands, **dict(zip(names, xs))})

    wrapped, _ = solver_backends.shard_scenarios(
        kern, operands[names[0]].shape[0], len(names), n_out)
    return wrapped(*(operands[k] for k in names))


def _solve(mod, Fc, Hc, grid_dt, ro, v_init, Pc, **statics):
    """``mod.solve_tables_batch``, its scenarios sharded over the active
    process group (see :func:`_sharded`)."""
    return _sharded(
        lambda Fc, Hc, ro, v_init, Pc: mod.solve_tables_batch(
            Fc, Hc, grid_dt, ro, v_init, Pc, **statics),
        2, Fc=Fc, Hc=Hc, ro=ro, v_init=v_init, Pc=Pc)


def _dispatch_refined(mod, dists, Fc, Hc, grid_dt, ro, v_init, rplan,
                      refine_check: str, price, Pc, dev, *, j_max: int,
                      t_max: int, delta_steps: int, n_sweeps: int):
    """The coarse-to-fine pipeline (see ``solver_backends.refine``) on the
    backend module ``mod``: a coarse hint solve at ``factor x grid_dt``
    (the dollar objective's on a coarse dollar grid from the same
    ``price``), its argmin table turned into per-segment candidate caps on
    the host, pruned pre-sweeps and one full-resolution sweep - falling
    back to ``mod``'s unrefined solve when the column-0 check (or the
    optional full check) fails.  The dollar restart overhead ``ro`` is
    shared between levels (the same launch cell at either resolution)."""
    statics = dict(j_max=j_max, t_max=t_max, delta_steps=delta_steps,
                   n_sweeps=n_sweeps)
    factor, radius = rplan["factor"], rplan["radius"]
    j_max_c, delta_c = rplan["j_max_c"], rplan["delta_steps_c"]
    dt_c = grid_dt * factor
    fh = [cdf_grids(d, dt_c, dev) for d in dists]
    t_max_c = fh[0][2]
    Fc_c = torch.stack([g[0] for g in fh])
    Hc_c = torch.stack([g[1] for g in fh])
    Pc_c = None
    if Pc is not None:
        Pc_c, _ = _dollar_inputs(price, dt_c, t_max_c, j_max_c, delta_c, 0.0,
                                 len(dists), dev)
    _, Kc = _solve(mod, Fc_c, Hc_c, dt_c, ro, None, Pc_c, j_max=j_max_c,
                   t_max=t_max_c, delta_steps=delta_c, n_sweeps=n_sweeps)
    caps = refine_mod.candidate_caps(
        Kc, refine_mod.cone_segments(j_max, t_max, delta_steps),
        factor=factor, radius=radius, j_max_c=j_max_c, t_max_c=t_max_c)
    V, K, ok = _sharded(
        lambda Fc, Hc, ro, v_init, Pc: refine_mod.refined_solve(
            mod, Fc, Hc, grid_dt, ro, v_init, Pc, caps=caps, **statics),
        3, Fc=Fc, Hc=Hc, ro=ro, v_init=v_init, Pc=Pc)
    info = dict(rplan, applied=True, t_max_c=t_max_c, caps=list(caps),
                verified_col0=bool(ok.all()), fallback=False)
    if not info["verified_col0"]:
        # a cap cut off an argmin on the restart-cost chain: serve the
        # unrefined solve instead
        V, K = _solve(mod, Fc, Hc, grid_dt, ro, v_init, Pc, **statics)
        info["fallback"] = True
    elif refine_check == "full":
        # compare the whole refined table with the unrefined solve (costs
        # more than the solve it checks)
        Vf, Kf = _solve(mod, Fc, Hc, grid_dt, ro, v_init, Pc, **statics)
        info["full_check_match"] = bool(torch.equal(V, Vf)) \
            and bool(torch.equal(K, Kf))
        if not info["full_check_match"]:
            V, K = Vf, Kf
            info["fallback"] = True
    return V, K, info


def solve_batch(dists: Sequence, job_steps: int, *,
                grid_dt: float = 1.0 / 60.0, delta_steps: int = 1,
                n_sweeps: int = 3, restart_overhead: float = 0.0, v_init=None,
                backend: str = "auto", refine: bool = False,
                refine_factor: int = 4, refine_radius: Optional[int] = None,
                refine_check: str = "col0", objective: str = "makespan",
                price=None, device="cuda") -> BatchDPTables:
    """Solve the checkpointing DP for a scenario batch sharing one deadline.

    ``backend`` is ``"auto"`` (the CUDA kernel on a CUDA device, the plain
    recurrence otherwise), ``"reference"`` or ``"cuda"``.  ``v_init``
    warm-starts the restart-cost fixed point from a previous solve's
    ``(S, j_max+1, t_max+1)`` V of the same objective.

    ``refine=True`` runs the coarse-to-fine pipeline on that backend: a
    coarse solve at ``refine_factor x grid_dt`` supplies argmin hints that
    cap the pre-sweeps' candidate axis (to ``factor*K_c + refine_radius``
    per segment, ``refine_radius`` 3 x the factor by default) inside the
    column-0 dependency cone, and the final sweep is the backend's solve
    at full resolution.  A bit-level column-0 check guards every
    pre-sweep and falls back to the unrefined solve on failure
    (``refine_check="full"`` also compares the whole table).
    ``refine_info`` records the plan, the caps and the outcome; a grid too
    small to refine (or one sweep) is solved plainly with
    ``{"applied": False, "reason": "degenerate"}``.  Refinement is kept for
    parity with ``repro`` and is SLOWER on CUDA: its row-serial pre-sweeps
    cost 15-23x the one-launch kernel solve at the sweep's size (PERF.md
    section 5), so leave it off there unless a capped-candidate kernel mode
    is measured to pay.

    ``objective="dollars"`` with ``price=`` (``prices``/``cum``/``dt`` of a
    price grid; one row broadcasts, otherwise one row per scenario) makes V
    the expected dollars-to-completion:

        V[j, t] = min_i  P_succ * ( dP(t, w) + V[j-i, t+w] )
                       + P_fail * ( E_lost * dP(t, w) / (w*dt) + R_j )

    with ``dP(t, w) = Pc(t+w) - Pc(t)`` and ``R_j = restart_overhead x
    launch price + V[j, 0]``.

    Under ``repro_torch.sharding.use(group)`` each solve splits its S
    scenarios over the group's ranks when the group's size divides S
    (``solver_backends.shard_scenarios``): every rank makes this call with
    the same arguments, solves its block, and returns the whole tables,
    equal bit for bit to the one-process solve.
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
    mod = solver_backends.get(name)
    statics = dict(j_max=int(job_steps), t_max=t_max,
                   delta_steps=int(delta_steps), n_sweeps=n_sweeps)
    rplan = refine_info = None
    if refine:
        if refine_check not in ("col0", "full"):
            raise ValueError(f"refine_check={refine_check!r}; expected "
                             f"'col0' or 'full'")
        rplan = refine_mod.plan(int(job_steps), t_max, int(delta_steps),
                                n_sweeps, refine_factor, refine_radius)
        refine_info = {"applied": False, "reason": "degenerate"}
    if rplan is None:
        V, K = _solve(mod, Fc, Hc, grid_dt, ro, v_init, Pc, **statics)
    else:
        V, K, refine_info = _dispatch_refined(
            mod, dists, Fc, Hc, grid_dt, ro, v_init, rplan, refine_check,
            price, Pc, dev, **statics)
    return BatchDPTables(V=V, K=K, grid_dt=grid_dt,
                         delta_steps=int(delta_steps),
                         restart_overhead=restart_overhead, horizon_idx=t_max,
                         backend=name + ("+refine" if refine else ""),
                         refine_info=refine_info, objective=objective)


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


def evaluate_policy_dollars(K, dists: Sequence, price, *, grid_dt: float,
                            delta_steps: int = 1, n_sweeps: int = 3,
                            restart_overhead: float = 0.0,
                            device="cuda") -> torch.Tensor:
    """Expected dollars-to-completion of executing FIXED policy tables
    ``K`` under the dollar objective's own model: the dollar recurrence in
    float64 with the min over candidate intervals replaced by K's choice
    (clipped to ``[1, j]``), through the same restart-cost fixed point and
    row order as the solver, batched over the S scenarios.

    Because the solver minimizes over every candidate the evaluator
    follows, ``solve_batch(objective="dollars").V <= evaluate(K_any)`` per
    sweep (up to the solver's float32 argmin slack), which lets a
    makespan-optimal K and a dollar-optimal K be compared in the same
    currency without Monte-Carlo noise.

    ``K``: ``(S, j_max+1, t_max+1)`` int tables (tensor or array);
    ``dists``: the S lifetime models; ``price``: a price grid (one row
    broadcasts).  Runs on ``device`` and returns float64
    ``(S, j_max+1, t_max+1)`` dollar tables there; entry ``[s, J, 0]`` is
    the expected cost of a fresh J-step job.
    """
    dev = resolve_device(device)
    if not isinstance(K, torch.Tensor):
        K = torch.from_numpy(np.array(K))
    K = K.to(device=dev, dtype=torch.int64)
    S, J1, T = K.shape
    j_max, t_max = J1 - 1, T - 1
    prices = np.asarray(price.prices, np.float64)
    cum = np.asarray(price.cum, np.float64)
    if prices.shape[0] == 1 and S > 1:
        prices = np.broadcast_to(prices, (S, prices.shape[1]))
        cum = np.broadcast_to(cum, (S, cum.shape[1]))
    # the cumulative-dollar grid on the age axis, in host float64 as the
    # solver's grids are built
    pdt = float(price.dt)
    TX = t_max + 1 + j_max + int(delta_steps)
    tau = np.arange(TX, dtype=np.float64) * grid_dt
    kc = np.clip(np.floor(tau / pdt).astype(np.int64), 0,
                 prices.shape[1] - 1)
    Pc = torch.as_tensor(
        cum[:, kc] + prices[:, kc] * (tau[None, :] - kc[None, :] * pdt),
        device=dev)
    P0 = torch.as_tensor(np.ascontiguousarray(prices[:, 0]), device=dev)
    tk = torch.arange(T, dtype=torch.float64, device=dev) * grid_dt
    F = torch.stack([torch.clamp(d.cdf(tk), 0.0, 1.0) for d in dists])
    atom = torch.clamp(1.0 - F[:, -1], min=0.0)
    F[:, -1] = 1.0
    H = torch.stack([d.partial_expectation(torch.zeros_like(tk), tk)
                     for d in dists]).clone()
    H[:, -1] += atom * torch.tensor([float(d.L) for d in dists],
                                    dtype=torch.float64, device=dev)
    dead = (1.0 - F) < 1e-6
    t = torch.arange(T, device=dev)[None, :].expand(S, T)
    t_hours = t.to(torch.float64) * grid_dt
    rows = torch.arange(S, device=dev)[:, None]
    V = Pc[:, :J1, None].expand(S, J1, T).clone()
    for _ in range(n_sweeps):
        R = float(restart_overhead) * P0[:, None] + V[:, :, 0].clone()
        for j in range(1, J1):
            i = torch.clamp(K[:, j], 1, j)
            w = torch.where(i == j, i, i + int(delta_steps))
            endx = t + w
            end = torch.clamp(endx, max=t_max)
            Ft, Fe = torch.gather(F, 1, t), torch.gather(F, 1, end)
            p_fail = torch.clamp(
                (Fe - Ft) / torch.clamp(1.0 - Ft, min=_EPS), 0.0, 1.0)
            dF = torch.clamp(Fe - Ft, min=_EPS)
            w_hours = w.to(torch.float64) * grid_dt
            e_lost = (torch.gather(H, 1, end) - torch.gather(H, 1, t)) / dF \
                - t_hours
            e_lost = torch.minimum(torch.clamp(e_lost, min=0.0), w_hours)
            dP = torch.gather(Pc, 1, endx) - torch.gather(Pc, 1, t)
            pb = dP / w_hours
            v_succ = dP + V[rows, j - i, end]
            Rj = R[:, j:j + 1]
            v_fail = e_lost * pb + Rj
            vj = (1.0 - p_fail) * v_succ + p_fail * v_fail
            V[:, j] = torch.where(dead, Rj, vj)
    return V


# ---------------------------------------------------------------------------
# Monte-Carlo executor (Fig. 7 evaluation): the per-trial reference
#
# This per-trial loop on the host is the semantic ground truth that
# ``engine.simulate_makespan_batch`` is held to, not a path to speed up.
# Lifetimes are converted to grid-step units (minus the first VM's sub-grid
# age offset) outside the loop, so the loop compares integers against
# precomputed floats and its only float accumulation is the sum of
# preempted partial segments: on a shared pool the engine's float64 lanes
# perform the same IEEE operations and the makespans agree to the bit.
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def simulate_makespan(policy_fn, lifetimes_fn, job_steps: int, *,
                      grid_dt: float = 1.0 / 60.0, delta_steps: int = 1,
                      start_age: float = 0.0, n_trials: int = 2000,
                      seed: int = 0, restart_overhead: float = 0.0,
                      max_restarts: int = 64, pool=None, first=None):
    """Execute a job under sampled preemptions, one trial at a time on the
    host.

    ``policy_fn(remaining_steps, age_idx) -> steps until next checkpoint``;
    ``lifetimes_fn(rng, n, min_age=0.0)`` samples lifetimes (hours)
    conditioned on survival to ``min_age`` (the first VM of a job that
    starts on an aged machine).  Alternatively pass pre-drawn ``first``
    ``(n_trials,)`` and ``pool`` ``(n_trials, max_restarts+2)`` (arrays or
    tensors, copied to the host) from ``engine.draw_lifetime_pool``.

    A failure during a work segment or the checkpoint write loses progress
    back to the last durable checkpoint; the job resumes on a fresh VM
    (age 0) after ``restart_overhead`` hours.  A trial that exhausts
    ``max_restarts`` reports the time it accumulated.  Returns float64
    makespans (hours), shape ``(n_trials,)``.
    """
    if pool is None:
        from .. import engine

        first, pool = engine.draw_lifetime_pool(
            lifetimes_fn, n_trials, max_restarts=max_restarts, seed=seed,
            start_age=start_age)
    pool = _host(pool)
    first = pool[:, 0] if first is None else _host(first)
    n_trials = len(first)
    age0_idx = int(round(start_age / grid_dt))
    off0 = start_age - age0_idx * grid_dt
    first_steps = (first - off0) / grid_dt
    pool_steps = pool / grid_dt
    out = np.empty((n_trials,), np.float64)
    for n in range(n_trials):
        remaining = int(job_steps)
        age_idx = age0_idx
        draw = 0
        life_s = first_steps[n]
        done_steps = 0          # completed work+checkpoint segments (steps)
        lost_steps = 0.0        # preempted partial segments (steps)
        restarts = 0
        while remaining > 0 and restarts <= max_restarts:
            i = int(policy_fn(remaining, age_idx))
            i = max(1, min(i, remaining))
            w = i + (delta_steps if i < remaining else 0)
            if age_idx + w <= life_s:
                done_steps += w
                age_idx += w
                remaining -= i
            else:
                lost_steps += max(life_s - age_idx, 0.0)
                draw += 1
                life_s = pool_steps[n, min(draw, max_restarts + 1)]
                age_idx = 0
                restarts += 1
        out[n] = (done_steps + lost_steps) * grid_dt \
            + restarts * restart_overhead
    return out


def dp_policy_fn(tables: DPTables):
    """``policy_fn`` of the DP's table (read from a host copy of K)."""
    K = tables.K.cpu().numpy()
    j_hi, t_hi = K.shape[0] - 1, K.shape[1] - 1
    return lambda remaining, age_idx: int(
        K[min(max(remaining, 0), j_hi), min(max(age_idx, 0), t_hi)])


def young_daly_policy_fn(tau_hours: float, grid_dt: float):
    tau_steps = max(1, int(round(tau_hours / grid_dt)))
    return lambda remaining, age_idx: min(tau_steps, remaining)


def no_checkpoint_policy_fn():
    return lambda remaining, age_idx: remaining


def model_lifetimes_fn(dist, device="cuda"):
    """``lifetimes_fn`` of ``dist``: ``fn(rng, n, min_age=0.0)`` takes
    ``rng.uniform(size=n)`` from a numpy Generator, restricts it to
    ``[F(min_age), 1]`` when ``min_age > 0`` and inverts it on ``device``,
    the residual ``u >= F(L)`` mass preempted at ``L``
    (``engine.capped_model_draw`` with one model).  Returns a float64
    tensor on ``device``, bit-identical to the same uniforms' row of
    ``engine.draw_lifetime_pool_batch``."""
    from .. import engine

    dev = resolve_device(device)

    def fn(rng, n, min_age: float = 0.0):
        u = torch.as_tensor(rng.uniform(size=n), device=dev)[None, :]
        return engine.capped_model_draw([dist], u, min_age=min_age,
                                        device=dev)[0]

    return fn
