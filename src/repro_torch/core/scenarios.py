"""Scenario registry and the checkpointing sweep, in PyTorch (port of the
checkpointing half of ``repro.core.scenarios``).

A scenario names a market condition - zone x diurnal launch phase x VM
type - and resolves to a :class:`~repro_torch.core.distributions.
DiurnalConstrained` model.  :func:`sweep_checkpointing` expands
(scenario x policy x seed) over the device executor in ``repro``'s three
modes - ``"batched"`` (one DP solve, one pool draw and one executor run
for the whole grid), ``"grouped"`` (one solve, one executor run per
(seed, policy)) and ``"serial"`` (per scenario: a solve, a pool per seed,
an executor run per policy) - and returns one row per cell in ``repro``'s
row order and schema.  The three modes' rows are identical in every
field: each mode's DP tables, pools and executor lanes perform the same
per-scenario operations, so they agree to the bit.
:func:`sweep_service` expands (scenario x policy x cluster_size x seed)
over the batch service, serially on the host or as one batched loop on
the device.
:func:`sweep_market` bills the checkpointing executor's makespans in
dollars against the market's price grids, over calm and crunch regimes
and three cost policies; :func:`solve_market_tables` solves its DP tables
once for reuse.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import distributions as dists
from . import engine
from . import service as service_mod
from .policies import checkpointing as ckpt
from .policies import young_daly as yd

__all__ = ["Scenario", "register", "get", "names", "default_grid",
           "sweep_checkpointing", "sweep_service", "solve_market_tables",
           "sweep_market", "PHASE_CLOCKS", "ZONE_PARAMS"]

# Wall-clock launch hour per diurnal phase label.
PHASE_CLOCKS: Dict[str, float] = {"day": 20.0, "night": 8.0, "shoulder": 14.0}

# Per-zone capacity-pressure regimes: ``A_scale`` multiplies the type's
# fitted A, ``tau1_scale`` its initial-phase time constant.  us-east1-b
# (the paper's fits) is the identity zone.
ZONE_PARAMS: Dict[str, Dict[str, float]] = {
    "us-east1-b": dict(A_scale=1.0, tau1_scale=1.0),
    "us-central1-a": dict(A_scale=1.08, tau1_scale=0.85),   # tighter market
    "europe-west1-d": dict(A_scale=0.92, tau1_scale=1.20),  # slacker market
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named market condition the policies are evaluated against."""

    name: str
    vm_type: str = "n1-highcpu-16"
    phase: str = "shoulder"            # diurnal label (see PHASE_CLOCKS)
    zone: str = "us-east1-b"           # parameter regime (see ZONE_PARAMS)
    launch_clock: Optional[float] = None  # overrides the phase's clock
    dist_kwargs: Mapping = dataclasses.field(default_factory=dict)
    description: str = ""
    # a live fitted distribution (the closed-loop runtime's latest Eq. 1
    # refit) served as it is instead of the catalog resolution
    dist_override: Optional[object] = None

    @property
    def clock(self) -> float:
        if self.launch_clock is not None:
            return float(self.launch_clock)
        return PHASE_CLOCKS[self.phase]

    def dist(self):
        """The scenario's lifetime model: the zone's scaling applied to the
        type's base Eq. 1 fit, then ``dist_kwargs``; a ``dist_override``
        short-circuits all of it."""
        if self.dist_override is not None:
            return self.dist_override
        zone = ZONE_PARAMS[self.zone]
        base = dists.VM_TYPE_PARAMS[self.vm_type]
        kw = dict(A=base["A"] * zone["A_scale"],
                  tau1=base["tau1"] * zone["tau1_scale"])
        kw.update(self.dist_kwargs)
        return dists.diurnal_for(self.vm_type, self.clock, **kw)

    def coords(self) -> dict:
        """Grid coordinates every sweep row is tagged with."""
        return dict(scenario=self.name, vm_type=self.vm_type,
                    phase=self.phase, zone=self.zone, launch_clock=self.clock)


_REGISTRY: Dict[str, Scenario] = {}


def register(scenario: Scenario, *, overwrite: bool = False) -> Scenario:
    """Add a scenario to the registry; a taken name raises unless
    ``overwrite=True``."""
    if not overwrite and scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered "
                         f"(pass overwrite=True to replace it)")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get(name: str) -> Scenario:
    return _REGISTRY[name]


def names() -> list:
    return sorted(_REGISTRY)


def default_grid(vm_types: Sequence[str] = ("n1-highcpu-16", "n1-highcpu-32"),
                 phases: Sequence[str] = ("day", "night"),
                 zones: Sequence[str] = ("us-east1-b", "us-central1-a"),
                 ) -> list:
    """The (zone x diurnal phase x vm_type) product, 2 x 2 x 2 = 8
    scenarios by default (shared with the registry)."""
    out = []
    for zone, phase, vm_type in itertools.product(zones, phases, vm_types):
        name = f"{zone}/{phase}/{vm_type}"
        if name not in _REGISTRY:
            register(Scenario(
                name=name, vm_type=vm_type, phase=phase, zone=zone,
                description=f"{vm_type} in {zone} launched at the {phase} "
                            f"clock ({PHASE_CLOCKS[phase]:.0f}h)"))
        out.append(_REGISTRY[name])
    return out


def _resolve(scenarios) -> list:
    return [get(s) if isinstance(s, str) else s for s in scenarios]


_CKPT_POLICY_BUILDERS = ("dp", "young_daly", "none")


def _young_daly_steps(dist, grid_dt: float, delta_steps: int) -> int:
    """The Fig. 7 baseline's interval in grid steps: Young-Daly with the
    MTTF implied by THIS distribution's initial failure rate and the
    sweep's checkpoint-write cost."""
    tau = float(yd.interval(delta_steps * grid_dt,
                            yd.mttf_from_initial_rate(dist)))
    return max(1, int(round(tau / grid_dt)))


def _policy_tables(policy: str, tables: "ckpt.DPTables", job_steps: int,
                   grid_dt: float, delta_steps: int, dist):
    """One scenario's 2-D policy table (the serial mode)."""
    if policy == "dp":
        return engine.dp_policy_table(tables)
    if policy == "young_daly":
        return engine.young_daly_policy_table(
            _young_daly_steps(dist, grid_dt, delta_steps), job_steps)
    if policy == "none":
        return engine.no_checkpoint_policy_table(job_steps)
    raise ValueError(f"unknown checkpointing policy {policy!r}; "
                     f"choose from {_CKPT_POLICY_BUILDERS}")


def _policy_tables_batch(policy: str, batch: "ckpt.BatchDPTables",
                         job_steps: int, grid_dt: float, delta_steps: int,
                         dist_list):
    """Per-scenario policy tables ((S, ...) tensor or array) or one shared
    2-D table for scenario-independent policies."""
    if policy == "dp":
        return engine.dp_policy_table(batch)
    if policy == "young_daly":
        return np.stack([engine.young_daly_policy_table(
            _young_daly_steps(dist, grid_dt, delta_steps), job_steps)
            for dist in dist_list])
    if policy == "none":
        return engine.no_checkpoint_policy_table(job_steps)
    raise ValueError(f"unknown checkpointing policy {policy!r}; "
                     f"choose from {_CKPT_POLICY_BUILDERS}")


def _ckpt_row(sc, policy, seed, mk, finished, *, n_trials, job_steps,
              p_fail_fresh, expected_makespan_dp):
    ok = mk[finished]
    return dict(
        sc.coords(), policy=policy, seed=seed,
        n_trials=n_trials, job_steps=job_steps,
        p_fail_fresh=p_fail_fresh,
        expected_makespan_dp=expected_makespan_dp,
        makespan_mean=float(ok.mean()) if ok.size else float("nan"),
        makespan_p50=float(np.median(ok)) if ok.size else float("nan"),
        makespan_p95=float(np.percentile(ok, 95)) if ok.size else float("nan"),
        unfinished_frac=float(1.0 - finished.mean()))


def cell_tables(batch: "ckpt.BatchDPTables", dist_list, policies, seeds, *,
                job_steps: int, grid_dt: float, delta_steps: int,
                device="cuda"):
    """The executor inputs of a sweep's ``B = S*R*P`` cells, in row order
    ``b = (s*R + r)*P + p``: ``(table_u, table_ix, pool_ix)``, where
    ``table_u`` stacks the unique policy tables on ``device`` (one per
    scenario for the per-scenario policies, one shared for the others),
    ``table_ix[b]`` picks cell b's table and ``pool_ix[b] = s*R + r`` its
    (scenario, seed) pool."""
    ptables = {p: _policy_tables_batch(p, batch, job_steps, grid_dt,
                                       delta_steps, dist_list)
               for p in policies}
    S, P, R = len(dist_list), len(policies), len(seeds)
    uniq, keys = [], {}
    table_ix = np.empty(S * R * P, np.int64)
    for b, (s, _seed, policy) in enumerate(
            itertools.product(range(S), seeds, policies)):
        key = (policy, s if ptables[policy].ndim == 3 else -1)
        if key not in keys:
            keys[key] = len(uniq)
            uniq.append(ptables[policy][s] if key[1] >= 0
                        else ptables[policy])
        table_ix[b] = keys[key]
    table_u = engine.stack_policy_tables(uniq, t_axis=batch.K.shape[2],
                                         device=device)
    return table_u, table_ix, np.repeat(np.arange(S * R), P)


def sweep_checkpointing(scenarios: Iterable, *,
                        policies: Sequence[str] = ("dp", "young_daly", "none"),
                        seeds: Sequence[int] = (0,), job_steps: int = 300,
                        n_trials: int = 1000, grid_dt: float = 1.0 / 60.0,
                        delta_steps: int = 1, max_restarts: int = 64,
                        restart_overhead: float = 0.0, n_sweeps: int = 3,
                        mode: str = "batched",
                        tables: Optional["ckpt.BatchDPTables"] = None,
                        solver_backend: str = "auto",
                        solver_refine: bool = False,
                        device="cuda") -> list:
    """Expand (scenario x policy x seed) over the device executor.

    ``mode="batched"`` (default) folds the whole grid: one
    ``checkpointing.solve_batch`` call solves every scenario's DP (or
    ``tables``, a ``BatchDPTables`` for this scenario list, is reused), one
    ``engine.draw_lifetime_pool_batch`` call draws every (scenario, seed)
    pool, and one ``engine.simulate_makespan_batch`` run executes all
    ``B = S*P*R`` cells.  Cell ``b`` is the row-order index
    ``(s*R + r)*P + p``; its pool is shared by the P policies of its
    (scenario, seed) and its table by the R seeds of its (scenario, policy),
    both through the executor's table/pool indices.

    ``mode="grouped"`` solves (or reuses ``tables``) in one call too, then
    per seed draws one pool for every scenario and runs one executor call
    per (seed, policy).  ``mode="serial"`` is the per-scenario reference
    path: one ``checkpointing.solve`` (``solve_batch`` at S = 1), one
    ``engine.draw_lifetime_pool`` per seed through
    ``checkpointing.model_lifetimes_fn`` and one executor call per policy,
    scenario by scenario; it takes no ``tables`` and ignores
    ``solver_backend`` / ``solver_refine``.

    All modes give identical rows.  Truncated trials are NaN-flagged and
    excluded from the row statistics; ``unfinished_frac`` records them.
    ``solver_backend`` / ``solver_refine`` pass through to
    ``solve_batch``'s ``backend`` / ``refine`` (refinement is slower than
    the plain solve on CUDA; see ``solve_batch``).
    """
    if mode not in ("batched", "grouped", "serial"):
        raise ValueError(f"mode must be 'batched', 'grouped' or 'serial', "
                         f"got {mode!r}")
    dev = resolve_device(device)
    scs = _resolve(scenarios)          # once: scenarios may be a generator
    if tables is not None:
        if mode == "serial":
            raise ValueError("tables= reuse is for the batched/grouped "
                             "modes; the serial reference path always "
                             "re-solves")
        if len(tables) != len(scs) or tables.K.shape[1] != job_steps + 1:
            raise ValueError(
                f"tables has {len(tables)} scenarios x j_max "
                f"{tables.K.shape[1] - 1}; this sweep needs "
                f"{len(scs)} x {job_steps}")
        if tables.delta_steps != delta_steps \
                or abs(tables.grid_dt - grid_dt) > 1e-12 \
                or tables.restart_overhead != restart_overhead:
            raise ValueError("tables was solved for a different "
                             "(grid_dt, delta_steps, restart_overhead) "
                             "workload")
    ex_kw = dict(grid_dt=grid_dt, delta_steps=delta_steps,
                 restart_overhead=restart_overhead,
                 max_restarts=max_restarts, unfinished="nan",
                 return_finished=True, device=dev)
    rows = []
    if mode == "serial":
        for sc in scs:
            dist = sc.dist()
            dp = ckpt.solve(dist, job_steps, grid_dt=grid_dt,
                            delta_steps=delta_steps, n_sweeps=n_sweeps,
                            restart_overhead=restart_overhead, device=dev)
            ptables = {p: _policy_tables(p, dp, job_steps, grid_dt,
                                         delta_steps, dist)
                       for p in policies}
            lifetimes_fn = ckpt.model_lifetimes_fn(dist, device=dev)
            p_fail_fresh = float(dist.cdf(job_steps * grid_dt))
            expected = dp.expected_makespan(job_steps)
            for seed in seeds:
                first, pool = engine.draw_lifetime_pool(
                    lifetimes_fn, n_trials, max_restarts=max_restarts,
                    seed=seed)
                for policy in policies:
                    mk, fin = engine.simulate_makespan_batch(
                        ptables[policy], job_steps, first=first, pool=pool,
                        **ex_kw)
                    rows.append(_ckpt_row(
                        sc, policy, seed, mk, fin, n_trials=n_trials,
                        job_steps=job_steps, p_fail_fresh=p_fail_fresh,
                        expected_makespan_dp=expected))
        return rows

    dist_list = [sc.dist() for sc in scs]
    batch = tables if tables is not None else ckpt.solve_batch(
        dist_list, job_steps, grid_dt=grid_dt, delta_steps=delta_steps,
        n_sweeps=n_sweeps, restart_overhead=restart_overhead,
        backend=solver_backend, refine=solver_refine, device=dev)
    p_fail_fresh = [float(d.cdf(job_steps * grid_dt)) for d in dist_list]
    expected = batch.V[:, job_steps, 0].cpu().tolist()

    if mode == "grouped":
        ptables = {p: _policy_tables_batch(p, batch, job_steps, grid_dt,
                                           delta_steps, dist_list)
                   for p in policies}
        cells = {}
        for seed in seeds:
            first, pool = engine.draw_lifetime_pool_batch(
                dist_list, n_trials, max_restarts=max_restarts, seed=seed,
                device=dev)
            for policy in policies:
                cells[seed, policy] = engine.simulate_makespan_batch(
                    ptables[policy], job_steps, first=first, pool=pool,
                    **ex_kw)
        for s, sc in enumerate(scs):             # serial row order
            for seed in seeds:
                for policy in policies:
                    mk, fin = cells[seed, policy]
                    rows.append(_ckpt_row(
                        sc, policy, seed, mk[s], fin[s], n_trials=n_trials,
                        job_steps=job_steps, p_fail_fresh=p_fail_fresh[s],
                        expected_makespan_dp=expected[s]))
        return rows

    first_sr, pool_sr = engine.draw_lifetime_pool_batch(
        [d for d in dist_list for _ in seeds], n_trials,
        max_restarts=max_restarts,
        seed=[seed for _ in dist_list for seed in seeds], device=dev)
    table_u, table_ix, pool_ix = cell_tables(
        batch, dist_list, policies, seeds, job_steps=job_steps,
        grid_dt=grid_dt, delta_steps=delta_steps, device=dev)
    mk_b, fin_b = engine.simulate_makespan_batch(
        table_u, job_steps, first=first_sr[torch.as_tensor(pool_ix,
                                                           device=dev)],
        pool=pool_sr, table_index=table_ix, pool_index=pool_ix, **ex_kw)
    for b, (s, seed, policy) in enumerate(
            itertools.product(range(len(scs)), seeds, policies)):
        rows.append(_ckpt_row(
            scs[s], policy, seed, mk_b[b], fin_b[b], n_trials=n_trials,
            job_steps=job_steps, p_fail_fresh=p_fail_fresh[s],
            expected_makespan_dp=expected[s]))
    return rows


# ---------------------------------------------------------------------------
# batch-service sweep
# ---------------------------------------------------------------------------

def sweep_service(scenarios: Iterable, *,
                  policies: Sequence[str] = ("model", "memoryless"),
                  cluster_sizes: Sequence[int] = (16,),
                  seeds: Sequence[int] = (0,), n_jobs: int = 40,
                  job_hours: float = 2.0, jitter: float = 0.1,
                  mode: str = "serial", pool_size: int = 4096,
                  deadline_hours=None, deflate_factor: float = 0.5,
                  device="cuda", **kw) -> list:
    """Expand (scenario x policy x cluster_size x seed) over the batch
    service.  The model policy's reuse grids for ALL scenarios are one
    :class:`engine.ReuseTables` evaluation on ``device``, over the
    remaining-work values of the first scenario's grid (the bag lengths
    depend only on the seeds, so every scenario shares one axis).

    ``mode="serial"`` (ground truth) runs each scenario's cells through
    ``service.run_bag_grid`` with its view of that table, the event loops
    on the host; ``mode="batched"`` runs EVERY cell as one lane of one
    ``service_kernel`` loop on ``device``, and also allows
    ``deadline_hours`` admission control and ``"+deflate"`` policies.
    Returns flat dict rows with the headline service metrics, in
    ``repro``'s order and schema.
    """
    from . import service_kernel
    dev = resolve_device(device)
    if mode not in ("serial", "batched"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "serial" and deadline_hours is not None:
        raise ValueError("deadline admission control needs mode='batched'")
    scs = _resolve(scenarios)
    policies = tuple(policies)
    dist_list = [sc.dist() for sc in scs]
    bases = [service_kernel.split_policy(p)[0] for p in policies]
    tables = None
    if "model" in bases and kw.get("vectorized_reuse", True):
        tables = engine.ReuseTables(
            dist_list,
            service_mod.grid_reuse_values(dist_list[0], seeds=tuple(seeds),
                                          n_jobs=n_jobs, job_hours=job_hours,
                                          jitter=jitter, **kw),
            device=dev)

    def _row(sc, cell):
        r = cell["result"]
        return dict(
            sc.coords(), policy=cell["policy"],
            cluster_size=cell["cluster_size"], seed=cell["seed"],
            n_jobs=n_jobs, job_hours=job_hours,
            makespan=r.makespan, vm_hours=r.vm_hours, cost=r.cost,
            on_demand_cost=r.on_demand_cost,
            cost_reduction=r.cost_reduction,
            n_preemptions=r.n_preemptions,
            n_job_failures=r.n_job_failures,
            n_deflations=r.n_deflations, n_rejected=r.n_rejected,
            job_failure_rate=r.n_job_failures / max(n_jobs, 1))

    if mode == "batched":
        lengths = {s: service_mod._bag_lengths(n_jobs, job_hours, jitter, s)
                   for s in seeds}
        cells = [dict(dist_index=si, vm_type=sc.vm_type, policy=policy,
                      cluster_size=cs, seed=seed)
                 for si, sc in enumerate(scs)
                 for policy, cs, seed in itertools.product(
                     policies, tuple(cluster_sizes), tuple(seeds))]
        grid = service_kernel.run_cells_batched(
            cells=cells, dists=dist_list, lengths_by_seed=lengths,
            reuse_tables=tables, pool_size=pool_size,
            deadline_hours=deadline_hours, deflate_factor=deflate_factor,
            checkpointing=kw.get("checkpointing", False),
            ckpt_interval=kw.get("ckpt_interval", 0.5),
            ckpt_cost=kw.get("ckpt_cost", 1.0 / 60.0),
            return_jobs=False, device=dev)
        per_sc = len(grid) // max(len(scs), 1)
        return [_row(scs[i // per_sc], cell) for i, cell in enumerate(grid)]

    rows = []
    for si, sc in enumerate(scs):
        dist = dist_list[si]
        grid = service_mod.run_bag_grid(
            vm_types=(sc.vm_type,), policies=policies,
            cluster_sizes=tuple(cluster_sizes), seeds=tuple(seeds),
            n_jobs=n_jobs, job_hours=job_hours, jitter=jitter,
            dist_for=lambda _vm_type, dist=dist: dist, pool_size=pool_size,
            reuse_table=tables.view(si) if tables is not None else None,
            device=dev, **kw)
        rows.extend(_row(sc, cell) for cell in grid)
    return rows


# ---------------------------------------------------------------------------
# spot-market sweep (dollar-denominated policy evaluation)
# ---------------------------------------------------------------------------

_MARKET_POLICIES = ("fixed", "cheapest", "migrate")


def solve_market_tables(scenarios: Iterable, market, *,
                        regimes: Sequence[str] = ("calm", "crunch"),
                        job_steps: int = 300, grid_dt: float = 1.0 / 60.0,
                        delta_steps: int = 1, n_sweeps: int = 3,
                        restart_overhead: float = 0.0,
                        solver_backend: str = "auto",
                        solver_refine: bool = False,
                        dp_objective: str = "makespan",
                        device="cuda") -> dict:
    """One ``BatchDPTables`` per market regime, for :func:`sweep_market`'s
    ``tables=``.

    Each regime is solved against the crunch-coupled Eq. 1 models at its
    launch time (``market.crunch_dists``): calm tables equal the plain
    per-scenario tables, crunch tables price in the boosted early hazard.
    ``dp_objective="dollars"`` solves each regime under the dollar
    objective against the market's price grid seen from that regime's
    launch time (``market.grid().shift(launch_time)``).
    ``solver_refine`` passes through to ``solve_batch(refine=)`` (slower
    than the plain solve on CUDA; see ``solve_batch``)."""
    dev = resolve_device(device)
    scs = _resolve(scenarios)
    grid0 = market.grid() if dp_objective == "dollars" else None
    out = {}
    for regime in regimes:
        t0 = market.launch_time(regime)
        dist_list = market.crunch_dists(scs, t0)
        price = None if grid0 is None else grid0.shift(t0)
        out[regime] = ckpt.solve_batch(
            dist_list, job_steps, grid_dt=grid_dt, delta_steps=delta_steps,
            n_sweeps=n_sweeps, restart_overhead=restart_overhead,
            backend=solver_backend, refine=solver_refine,
            objective=dp_objective, price=price, device=dev)
    return out


def _market_row(sc, regime, policy, seed, chosen, launch_price, dollars,
                mk_row, fin_row, *, n_trials, job_steps, crunch):
    ok = np.asarray(fin_row, bool)
    d_ok = np.asarray(dollars)[ok]
    m_ok = np.asarray(mk_row)[ok]
    return dict(
        sc.coords(), regime=regime, policy=policy, seed=seed,
        chosen=chosen, launch_price=float(launch_price),
        n_trials=n_trials, job_steps=job_steps, crunch=bool(crunch),
        expected_dollars=float(d_ok.mean()) if d_ok.size else float("nan"),
        dollars_p50=float(np.median(d_ok)) if d_ok.size else float("nan"),
        makespan_mean=float(m_ok.mean()) if m_ok.size else float("nan"),
        unfinished_frac=float(1.0 - ok.mean()))


def _check_market_tables(tables, regime, S, job_steps, grid_dt, delta_steps,
                         restart_overhead, dp_objective):
    if regime not in tables:
        raise ValueError(f"tables= has no entry for regime {regime!r}")
    batch = tables[regime]
    if len(batch) != S or batch.K.shape[1] != job_steps + 1:
        raise ValueError(
            f"tables[{regime!r}] has {len(batch)} scenarios x j_max "
            f"{batch.K.shape[1] - 1}; this sweep needs {S} x {job_steps}")
    if batch.delta_steps != delta_steps \
            or abs(batch.grid_dt - grid_dt) > 1e-12 \
            or batch.restart_overhead != restart_overhead:
        raise ValueError("tables was solved for a different "
                         "(grid_dt, delta_steps, restart_overhead) workload")
    if batch.objective != dp_objective:
        raise ValueError(
            f"tables[{regime!r}] was solved with objective="
            f"{batch.objective!r}; this sweep requested "
            f"dp_objective={dp_objective!r}")
    return batch


def sweep_market(scenarios: Iterable, *, market=None,
                 regimes: Sequence[str] = ("calm", "crunch"),
                 policies: Sequence[str] = _MARKET_POLICIES,
                 seeds: Sequence[int] = (0,), job_steps: int = 300,
                 n_trials: int = 400, grid_dt: float = 1.0 / 60.0,
                 delta_steps: int = 1, max_restarts: int = 64,
                 restart_overhead: float = 0.0, n_sweeps: int = 3,
                 tables: Optional[dict] = None,
                 feasible_slack: float = 1.25,
                 migrate_threshold: float = 1.15,
                 migrate_overhead_hours: float = 2.0 / 60.0,
                 cost_path: str = "kernel",
                 solver_backend: str = "auto",
                 solver_refine: bool = False,
                 dp_objective: str = "makespan",
                 device="cuda") -> list:
    """Expand (scenario x regime x cost policy x seed) in dollars.

    Each regime launches the whole scenario grid at
    ``market.launch_time(regime)`` against the crunch-coupled Eq. 1 models,
    runs one executor pass over all scenarios per (regime, seed) on
    ``device``, and bills every trial's makespan against the launch-shifted
    ``(S, T)`` price grid through ``engine.accumulate_price_cost``.  The
    checkpoint schedule is always the DP table; the cost policies choose
    where a job runs and is billed:

    * ``"fixed"`` - the scenario's own leaf;
    * ``"cheapest"`` - at launch, the same-vm_type leaf with the lowest
      launch price among those whose DP expected cost is within
      ``feasible_slack`` of the own leaf's (the own leaf when none is
      cheaper);
    * ``"migrate"`` - start on the own leaf; from the first grid cell where
      the own price exceeds ``migrate_threshold`` times the substitute's,
      bill the substitute's prices, and charge trials still running at the
      crossing ``migrate_overhead_hours`` at the substitute's price there.

    ``tables=`` takes :func:`solve_market_tables`' per-regime tables and
    skips every solve (they must match the workload and ``dp_objective``).
    ``cost_path="reference"`` bills through the serial
    ``market.integrate_cost_ref`` loop instead of the gather.  Under
    ``dp_objective="dollars"`` the tables minimize expected dollars and the
    ``feasible_slack`` gate compares expected dollars.  ``solver_refine``
    passes through to ``solve_batch(refine=)`` (slower than the plain solve
    on CUDA; see ``solve_batch``).  Returns flat rows in ``repro``'s order
    and schema.
    """
    from . import market as market_mod
    dev = resolve_device(device)
    scs = _resolve(scenarios)
    S = len(scs)
    if market is None:
        market = market_mod.MarketModel.for_scenarios(scs)
    if len(market) != S:
        raise ValueError(f"market has {len(market)} leaves for {S} scenarios")
    if cost_path not in ("kernel", "reference"):
        raise ValueError(f"cost_path must be 'kernel' or 'reference', "
                         f"got {cost_path!r}")
    unknown = set(policies) - set(_MARKET_POLICIES)
    if unknown:
        raise ValueError(f"unknown market policies {sorted(unknown)}; "
                         f"choose from {_MARKET_POLICIES}")

    def bill(grid, mk, price_index):
        if cost_path == "kernel":
            return engine.accumulate_price_cost(grid, mk, price_index,
                                                device=dev)
        return np.array([
            [market_mod.integrate_cost_ref(grid.prices[price_index[s]],
                                           grid.cum[price_index[s]],
                                           grid.dt, m)
             for m in mk[s]] for s in range(S)])

    grid0 = market.grid()
    T = grid0.prices.shape[1]
    rows = []
    for regime in regimes:
        t0 = market.launch_time(regime)
        dist_list = market.crunch_dists(scs, t0)
        g = grid0.shift(t0)
        if tables is not None:
            batch = _check_market_tables(tables, regime, S, job_steps,
                                         grid_dt, delta_steps,
                                         restart_overhead, dp_objective)
        else:
            batch = ckpt.solve_batch(
                dist_list, job_steps, grid_dt=grid_dt,
                delta_steps=delta_steps, n_sweeps=n_sweeps,
                restart_overhead=restart_overhead, backend=solver_backend,
                refine=solver_refine, objective=dp_objective,
                price=g if dp_objective == "dollars" else None, device=dev)
        # per-leaf expected cost of a fresh job (hours, or dollars under the
        # dollar objective): the substitution policies' feasibility signal
        exp_mk = batch.V[:, job_steps, 0].double().cpu().numpy()
        launch_p = g.prices[:, 0]
        crunch_on = [regime == "crunch" and p.crunched
                     for p in market.processes]
        # cheapest-feasible substitute per leaf, resolved at launch (ties
        # keep the own leaf: substitution must strictly win)
        target = np.arange(S)
        for s in range(S):
            cands = [j for j in range(S)
                     if scs[j].vm_type == scs[s].vm_type
                     and exp_mk[j] <= feasible_slack * exp_mk[s]
                     and launch_p[j] < launch_p[s]]
            if cands:
                target[s] = min(cands, key=lambda j: launch_p[j])
        # migrate-on-price-signal: the own prefix, then the substitute's
        # suffix from the first cell where the own price exceeds threshold x
        # the substitute's
        composed = g.prices.copy()
        kc = np.full(S, T, np.int64)
        for s in range(S):
            j = target[s]
            if j == s:
                continue
            hit = np.flatnonzero(g.prices[s]
                                 > migrate_threshold * g.prices[j])
            if hit.size:
                kc[s] = hit[0]
                composed[s, hit[0]:] = g.prices[j, hit[0]:]
        g_migrate = market_mod.PriceGrid.from_prices(composed, g.dt)

        ptab = engine.dp_policy_table(batch).to(dev)
        idx = np.arange(S, dtype=np.int64)
        for seed in seeds:
            first, pool = engine.draw_lifetime_pool_batch(
                dist_list, n_trials, max_restarts=max_restarts, seed=seed,
                device=dev)
            mk, fin = engine.simulate_makespan_batch(
                ptab, job_steps, first=first, pool=pool, grid_dt=grid_dt,
                delta_steps=delta_steps, restart_overhead=restart_overhead,
                max_restarts=max_restarts, unfinished="nan",
                return_finished=True, device=dev)
            for policy in policies:
                if policy == "fixed":
                    chosen, m_bill, f_bill = idx, mk, fin
                    dollars = bill(g, m_bill, idx)
                elif policy == "cheapest":
                    chosen = target
                    m_bill, f_bill = mk[chosen], fin[chosen]
                    dollars = bill(g, m_bill, chosen)
                else:   # migrate
                    chosen, m_bill, f_bill = idx, mk, fin
                    dollars = bill(g_migrate, m_bill, idx)
                    cross_t = kc[:, None] * g.dt
                    sur = np.where(
                        m_bill > cross_t,
                        migrate_overhead_hours
                        * g.prices[target, np.minimum(kc, T - 1)][:, None],
                        0.0)
                    dollars = dollars + sur
                for s in range(S):
                    rows.append(_market_row(
                        scs[s], regime, policy, seed,
                        scs[int(chosen[s]) if policy != "migrate"
                            else int(target[s])].name,
                        launch_p[s], dollars[s], m_bill[s], f_bill[s],
                        n_trials=n_trials, job_steps=job_steps,
                        crunch=crunch_on[s]))
    return rows
