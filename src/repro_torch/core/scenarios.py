"""Scenario registry and the checkpointing sweep, in PyTorch (port of the
checkpointing half of ``repro.core.scenarios``).

A scenario names a market condition - zone x diurnal launch phase x VM
type - and resolves to a :class:`~repro_torch.core.distributions.
DiurnalConstrained` model.  :func:`sweep_checkpointing` expands
(scenario x policy x seed) into one DP solve, one pool draw and one
executor run on the device, and returns one row per cell in ``repro``'s
row order and schema.  :func:`sweep_service` expands
(scenario x policy x cluster_size x seed) over the batch service, serially
on the host or as one batched loop on the device.
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
           "sweep_checkpointing", "sweep_service", "PHASE_CLOCKS",
           "ZONE_PARAMS"]

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

    @property
    def clock(self) -> float:
        if self.launch_clock is not None:
            return float(self.launch_clock)
        return PHASE_CLOCKS[self.phase]

    def dist(self):
        """The scenario's lifetime model: the zone's scaling applied to the
        type's base Eq. 1 fit, then ``dist_kwargs``."""
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


def _policy_tables_batch(policy: str, batch: "ckpt.BatchDPTables",
                         job_steps: int, grid_dt: float, delta_steps: int,
                         dist_list):
    """Per-scenario policy tables ((S, ...) tensor or array) or one shared
    2-D table for scenario-independent policies."""
    if policy == "dp":
        return engine.dp_policy_table(batch)
    if policy == "young_daly":
        tabs = []
        for dist in dist_list:
            tau = float(yd.interval(delta_steps * grid_dt,
                                    yd.mttf_from_initial_rate(dist)))
            tau_steps = max(1, int(round(tau / grid_dt)))
            tabs.append(engine.young_daly_policy_table(tau_steps, job_steps))
        return np.stack(tabs)
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
                        tables: Optional["ckpt.BatchDPTables"] = None,
                        solver_backend: str = "auto",
                        device="cuda") -> list:
    """Expand (scenario x policy x seed) over the device executor: ``repro``'s
    ``mode="batched"`` fold.

    One ``checkpointing.solve_batch`` call solves every scenario's DP (or
    ``tables``, a ``BatchDPTables`` for this scenario list, is reused), one
    ``engine.draw_lifetime_pool_batch`` call draws every (scenario, seed)
    pool, and one ``engine.simulate_makespan_batch`` run executes all
    ``B = S*P*R`` cells.  Cell ``b`` is the row-order index
    ``(s*R + r)*P + p``; its pool is shared by the P policies of its
    (scenario, seed) and its table by the R seeds of its (scenario, policy),
    both through the executor's table/pool indices.  Truncated trials are
    NaN-flagged and excluded from the row statistics; ``unfinished_frac``
    records them.
    """
    dev = resolve_device(device)
    scs = _resolve(scenarios)          # once: scenarios may be a generator
    if tables is not None:
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
    dist_list = [sc.dist() for sc in scs]
    batch = tables if tables is not None else ckpt.solve_batch(
        dist_list, job_steps, grid_dt=grid_dt, delta_steps=delta_steps,
        n_sweeps=n_sweeps, restart_overhead=restart_overhead,
        backend=solver_backend, device=dev)
    p_fail_fresh = [float(d.cdf(job_steps * grid_dt)) for d in dist_list]
    expected = batch.V[:, job_steps, 0].cpu().tolist()
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
        pool=pool_sr, grid_dt=grid_dt, delta_steps=delta_steps,
        restart_overhead=restart_overhead, max_restarts=max_restarts,
        unfinished="nan", return_finished=True,
        table_index=table_ix, pool_index=pool_ix, device=dev)
    rows = []
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
