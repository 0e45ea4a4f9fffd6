"""Closed-loop fleet runtime: stream -> track -> refit -> re-solve -> swap
(port of ``repro.core.runtime``).

The paper's Discussion made executable: "a long-running cloud service can
continuously update the model based on recent preemption behavior".

::

    FleetStream / FaultInjector                 (lifetime observations)
          |
          v
    OnlineModelTracker.observe()                (rolling window, KS drift)
          |  confirmed change point
          v
    fitting.fit_samples (Eq. 1 refit)  --fail-> retry w/ backoff, keep model
          |  finite theta
          v
    checkpointing.solve_batch          --fail-> retry w/ backoff, keep tables
      (warm-started from last V)
          |  validate() + validate_policy_table
          v
    atomic hot-swap of BatchDPTables + live-scenario dist_override
          |
          v
    sweep_checkpointing(..., tables=live)       (fleet keeps serving)

Every stage is guarded so the fleet never serves from a half-written or
NaN table: a diverged or degenerate fit keeps the last-good model and
retries with a doubling backoff (``tracker.defer_refit``); a solve over
its wall-clock budget (``SolveTimeout``), an injected timeout or a table
that fails validation keeps the last-good tables, with a staleness count
from change-point confirmation to the swap.  Instrumentation: the
adaptation lag (observations from an injected drift to the swap that
answers it) and the stale-table makespan regret (one pool, stale K against
fresh K).

Everything on the device side runs on ``device``: the fits, every DP solve
(one ``dp_recurrence`` launch each on the card, two with
``solver_refine``), the regret probe's pool and executor, and the default
stream's draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import engine, fitting, online
from . import scenarios as SC
from . import simulator
from .policies import checkpointing as ckpt

FLEET_VM_TYPES = simulator.FLEET_VM_TYPES


class SolveTimeout(RuntimeError):
    """A DP re-solve exceeded its wall-clock budget (real or injected)."""


@dataclasses.dataclass
class FleetStream:
    """Block-buffered lifetime stream over ``simulator.generate_fleet_trace``
    drawn from a seeded ``torch.Generator`` on ``device``: ``block``
    lifetimes a refill, popped one observation at a time.  ``set_regime``
    switches the fleet's VM-type mix mid-stream (the injected drift) and
    drops buffered draws of the old regime."""
    seed: int = 0
    block: int = 256
    vm_types: tuple = FLEET_VM_TYPES
    device: str = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        self._gen = torch.Generator(device=dev).manual_seed(self.seed)
        self._buf: list = []

    def set_regime(self, vm_types: Sequence[str]):
        self.vm_types = tuple(vm_types)
        self._buf = []

    def _refill(self):
        tr = simulator.generate_fleet_trace(self._gen, n_vms=self.block,
                                            vm_types=self.vm_types)
        self._buf = tr.lifetime.double().cpu().tolist()

    def next(self) -> float:
        if not self._buf:
            self._refill()
        return float(self._buf.pop())


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    # evaluation workload (shared by the DP solve and the regret probe)
    base_scenarios: tuple = ()          # names/Scenarios solved alongside live
    job_steps: int = 60
    grid_dt: float = 0.1
    delta_steps: int = 1
    restart_overhead: float = 0.0
    n_sweeps: int = 3
    warm_sweeps: int = 2                # sweeps when warm-started from last V
    warm_start: bool = True
    max_restarts: int = 64
    # passed straight through to checkpointing.solve_batch
    solver_backend: str = "auto"
    # coarse-to-fine pre-sweep pruning: kept for parity with repro, and
    # slower than the plain kernel solve on CUDA (PERF.md section 5)
    solver_refine: bool = False
    # "makespan" optimises expected hours-to-completion; "dollars" prices
    # every segment off the live ticker (needs a price_feed)
    dp_objective: str = "makespan"
    # tracker
    window: int = 256
    refit_every: int = 64
    min_samples: int = 64
    # robustness envelope
    retry_backoff_obs: int = 16         # doubles per consecutive failure
    max_retries: int = 3
    solve_budget_s: float = 60.0
    # regret probe
    regret_trials: int = 256
    regret_seed: int = 123
    # stream
    stream_seed: int = 0
    stream_block: int = 256
    stream_vm_types: tuple = FLEET_VM_TYPES
    live_name: str = "live/fleet"


@dataclasses.dataclass(frozen=True)
class SwapRecord:
    obs: int                            # observation index of the swap
    reason: str                         # "initial-fit" | "change-point"
    warm: bool                          # warm-started from the previous V
    solve_seconds: float
    stale_obs: int                      # observations served stale before it
    lag_from_drift: Optional[int]       # obs since last injected drift
    regret_hours: Optional[float] = None  # what serving stale K was costing
    regret_frac: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RuntimeReport:
    n_obs: int
    n_refits: int
    change_points: int
    swaps: tuple
    events: tuple                       # (obs, kind, detail)
    retries: dict                       # {"fit": n, "solve": n}
    degraded: bool                      # serving last-good past retry budget
    stale_obs_total: int
    adaptation_lag_obs: Optional[int]   # first injected drift -> its swap
    regret_hours: Optional[float]       # stale-K minus fresh-K mean makespan
    regret_frac: Optional[float]
    # market billing (with a price_feed): every streamed lifetime billed at
    # its launch price off the live ticker
    vm_hours_streamed: float = 0.0
    dollars_streamed: float = 0.0
    mean_price: Optional[float] = None  # dollars / vm-hours


class FleetRuntime:
    """The closed loop.  ``run(n_obs)`` streams observations through the
    pipeline and returns a :class:`RuntimeReport`; ``evaluate()`` re-runs
    the standing policy sweep from the CURRENT live tables at any time.
    ``stream`` is any object with ``next()`` and ``set_regime()`` (default:
    a :class:`FleetStream` on ``device``)."""

    def __init__(self, config: Optional[RuntimeConfig] = None, *,
                 injector=None, stream=None, price_feed=None,
                 device="cuda"):
        self.cfg = cfg = config or RuntimeConfig()
        self.device = dev = resolve_device(device)
        self.injector = injector
        # live market ticker (a market.PriceFeed): each streamed lifetime
        # is billed at the price the feed shows when the VM launches
        self.price_feed = price_feed
        if cfg.dp_objective == "dollars" and price_feed is None:
            raise ValueError("dp_objective='dollars' requires a price_feed: "
                             "the dollar DP prices segments off the live "
                             "ticker")
        self.vm_hours_streamed = 0.0
        self.dollars_streamed = 0.0
        self.stream = stream or FleetStream(seed=cfg.stream_seed,
                                            block=cfg.stream_block,
                                            vm_types=cfg.stream_vm_types,
                                            device=str(dev))
        self.tracker = online.OnlineModelTracker(
            window=cfg.window, refit_every=cfg.refit_every,
            min_samples=cfg.min_samples, fit_fn=self._guarded_fit,
            device=str(dev))
        base = SC._resolve(cfg.base_scenarios)
        self.live_sc = SC.register(
            SC.Scenario(name=cfg.live_name,
                        description="online-fitted fleet model (closed loop)",
                        dist_override=self.tracker.model),
            overwrite=True)
        self.scenario_names = tuple(s.name for s in base) + (cfg.live_name,)
        # telemetry / envelope state
        self.obs = 0
        self.events: list = []
        self.retries = {"fit": 0, "solve": 0}
        self.swaps: list = []
        self.degraded = False
        self.stale_obs_total = 0
        self._stale_since: Optional[int] = None
        self._seen_change_points = 0
        self._fit_attempts = 0
        self._solve_attempts = 0
        self._next_solve_retry = 0
        self._pending_swap: Optional[str] = None   # reason awaiting a solve
        self._last_drift_injected: Optional[int] = None
        self._adaptation_lags: list = []
        self._stale_tables: Optional[ckpt.BatchDPTables] = None
        # cold solve so the fleet serves validated tables from observation
        # 0 (the injector's schedule is indexed by observation and does not
        # apply to the bootstrap)
        self.live_tables: Optional[ckpt.BatchDPTables] = None
        self.live_tables = self._solve(warm=False, inject=False)

    # -- scenario/dist plumbing -------------------------------------------
    def _dists(self) -> list:
        out = [SC.get(n).dist() for n in self.scenario_names[:-1]]
        out.append(self.tracker.model)
        return out

    def _guarded_fit(self, family, data, **kw):
        """The tracker's fit hook: lets the injector fault the fit stage
        with the non-finite result a diverged fit would give, so the
        tracker's own validation rejects it."""
        if self.injector is not None \
                and self.injector.take("fit_divergence", self.obs):
            nan = torch.tensor(float("nan"), dtype=torch.float64)
            return fitting.FitResult(
                dist=self.tracker.model, theta=nan.expand(3), lse=nan,
                iterations=0, converged=False)
        return fitting.fit_samples(family, data, device=self.device, **kw)

    # -- solve stage -------------------------------------------------------
    def _solve(self, *, warm: bool, inject: bool = True) -> ckpt.BatchDPTables:
        cfg = self.cfg
        dists = self._dists()
        t_max = int(round(float(dists[-1].L) / cfg.grid_dt))
        want = (len(dists), cfg.job_steps + 1, t_max + 1)
        warm = (warm and cfg.warm_start and self.live_tables is not None
                and tuple(self.live_tables.V.shape) == want
                and self.live_tables.objective == cfg.dp_objective)
        if inject and self.injector is not None \
                and self.injector.take("solve_timeout", self.obs):
            raise SolveTimeout("injected solve timeout")
        # dollar objective: the live ticker from the market clock forward
        # over the solve horizon; one row broadcasts over scenarios
        price = (self.price_feed.grid(float(dists[-1].L))
                 if cfg.dp_objective == "dollars" else None)
        t0 = time.perf_counter()
        tab = ckpt.solve_batch(
            dists, cfg.job_steps, grid_dt=cfg.grid_dt,
            delta_steps=cfg.delta_steps,
            n_sweeps=cfg.warm_sweeps if warm else cfg.n_sweeps,
            restart_overhead=cfg.restart_overhead,
            v_init=self.live_tables.V if warm else None,
            backend=cfg.solver_backend, refine=cfg.solver_refine,
            objective=cfg.dp_objective, price=price, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if dt > cfg.solve_budget_s:
            raise SolveTimeout(f"solve took {dt:.2f}s "
                               f"(budget {cfg.solve_budget_s}s)")
        tab.validate()
        for s in range(len(tab)):
            engine.validate_policy_table(tab.K[s])
        self._last_solve_warm = warm
        self._last_solve_seconds = dt
        return tab

    def _try_swap(self, reason: str):
        """Solve + validate + atomically publish; on failure keep last-good
        tables and schedule a bounded backoff retry."""
        try:
            tab = self._solve(warm=True)
        except (SolveTimeout, ValueError) as e:
            self.retries["solve"] += 1
            self._solve_attempts += 1
            self._pending_swap = reason
            self.events.append((self.obs, "solve-failure", str(e)))
            if self._solve_attempts <= self.cfg.max_retries:
                back = self.cfg.retry_backoff_obs \
                    * 2 ** (self._solve_attempts - 1)
                self._next_solve_retry = self.obs + back
                self.events.append((self.obs, "solve-retry-scheduled",
                                    f"in {back} obs"))
            else:
                # degraded: last-good tables keep serving; the next burst
                # of attempts waits a full refit period with its own budget
                self.degraded = True
                self._next_solve_retry = self.obs + self.cfg.refit_every
                self._solve_attempts = 0
                self.events.append((self.obs, "solve-degraded",
                                    "retry budget exhausted; serving "
                                    "last-good tables"))
            return
        # swap: publish tables and the live scenario's dist together
        self._stale_tables = self.live_tables
        self.live_tables = tab
        self.live_sc = SC.register(
            dataclasses.replace(self.live_sc,
                                dist_override=self.tracker.model),
            overwrite=True)
        stale = (self.obs - self._stale_since
                 if self._stale_since is not None else 0)
        lag = (self.obs - self._last_drift_injected
               if self._last_drift_injected is not None else None)
        regret = None
        if reason == "change-point":
            # what the displaced table was costing, on the model the fleet
            # just adapted to; a failing probe records None, since
            # instrumentation must never take the loop down
            try:
                regret = self.measure_regret()
            except Exception:
                regret = None
        self.swaps.append(SwapRecord(
            obs=self.obs, reason=reason, warm=self._last_solve_warm,
            solve_seconds=self._last_solve_seconds, stale_obs=stale,
            lag_from_drift=lag,
            regret_hours=None if regret is None else regret[0],
            regret_frac=None if regret is None else regret[1]))
        if reason == "change-point" and lag is not None \
                and not self._adaptation_lags:
            self._adaptation_lags.append(lag)
        self.events.append((self.obs, "table-swap",
                            f"{reason}, warm={self._last_solve_warm}, "
                            f"stale_obs={stale}"))
        self._stale_since = None
        self._pending_swap = None
        self._solve_attempts = 0
        self.degraded = False

    # -- fit stage ---------------------------------------------------------
    def _on_fit_failure(self, exc: Exception):
        self.retries["fit"] += 1
        self._fit_attempts += 1
        self.events.append((self.obs, "fit-failure",
                            f"{type(exc).__name__}: {exc}"))
        if self._fit_attempts <= self.cfg.max_retries:
            back = self.cfg.retry_backoff_obs * 2 ** (self._fit_attempts - 1)
            self.tracker.defer_refit(back)
            self.events.append((self.obs, "fit-retry-scheduled",
                                f"in {back} obs"))
        else:
            # degraded: last-good model keeps serving; the next attempt
            # waits a full refit period with a fresh attempt budget
            self.degraded = True
            self.tracker.defer_refit(self.cfg.refit_every)
            self._fit_attempts = 0
            self.events.append((self.obs, "fit-degraded",
                                "retry budget exhausted; serving last-good "
                                "model"))

    # -- the loop ----------------------------------------------------------
    def step(self) -> None:
        """One observation through the whole pipeline."""
        inj = self.injector
        if self._stale_since is not None:
            self.stale_obs_total += 1
        storm = None
        if inj is not None:
            ev = inj.drift_event(self.obs)
            if ev is not None:
                p = ev.param or {}
                if "vm_types" in p:
                    self.stream.set_regime(p["vm_types"])
                self._last_drift_injected = self.obs
                self.events.append((self.obs, "drift-injected", str(p)))
            storm = inj.storm_active(self.obs)
        life = (inj.storm_lifetime(storm) if storm is not None
                else self.stream.next())
        if self.price_feed is not None:
            # bill the observed VM life at its launch price, then tick the
            # market clock (deterministic per feed seed)
            self.vm_hours_streamed += life
            self.dollars_streamed += life * self.price_feed.advance()
        # fit stage (the tracker validates the refit; failures keep
        # last-good)
        try:
            refit = self.tracker.observe(life)
            if refit:
                self._fit_attempts = 0
        except (fitting.FitDiverged, ValueError) as e:
            refit = False
            self._on_fit_failure(e)
        # change-point bookkeeping survives a failed fit: the window was
        # already trimmed, and the tables are stale from this moment on
        if self.tracker.change_points > self._seen_change_points:
            self._seen_change_points = self.tracker.change_points
            if self._stale_since is None:
                self._stale_since = self.obs
            self.events.append((self.obs, "change-point",
                                f"ks={self.tracker.last_ks:.3f} > "
                                f"cut={self.tracker.last_cut:.3f}"))
            if refit:
                self._try_swap("change-point")
        elif refit and self.tracker.n_refits == 1:
            # the first real fit replaces the prior model in the tables
            self._try_swap("initial-fit")
        elif self._pending_swap is not None \
                and self.obs >= self._next_solve_retry:
            self._try_swap(self._pending_swap)
        self.obs += 1

    def run(self, n_obs: int) -> RuntimeReport:
        for _ in range(int(n_obs)):
            self.step()
        return self.report()

    # -- instrumentation ---------------------------------------------------
    def measure_regret(self, *, n_trials: Optional[int] = None,
                       seed: Optional[int] = None):
        """Stale-table makespan regret on the live scenario, paired: one
        lifetime pool drawn from the current live model, executed under the
        pre-swap (stale) K and the current (fresh) K.  Returns
        ``(regret_hours, regret_frac)``, or None before the first swap or
        when an arm finished no trial."""
        if self._stale_tables is None:
            return None
        cfg = self.cfg
        n = int(n_trials or cfg.regret_trials)
        first, pool = engine.draw_lifetime_pool_batch(
            [self.live_sc.dist_override], n, max_restarts=cfg.max_restarts,
            seed=cfg.regret_seed if seed is None else seed,
            device=self.device)
        s = len(self.live_tables) - 1          # live slice is last
        kw = dict(first=first, pool=pool, grid_dt=cfg.grid_dt,
                  delta_steps=cfg.delta_steps,
                  restart_overhead=cfg.restart_overhead,
                  max_restarts=cfg.max_restarts, unfinished="nan",
                  device=self.device)
        mk_fresh = engine.simulate_makespan_batch(
            self.live_tables.K[s], cfg.job_steps, **kw)
        mk_stale = engine.simulate_makespan_batch(
            self._stale_tables.K[s], cfg.job_steps, **kw)
        # a storm-era model can leave EVERY trial unfinished (NaN-flagged)
        if not (np.isfinite(mk_fresh).any() and np.isfinite(mk_stale).any()):
            return None
        fresh = float(np.nanmean(mk_fresh))
        stale = float(np.nanmean(mk_stale))
        return stale - fresh, (stale - fresh) / fresh

    def report(self) -> RuntimeReport:
        # the headline regret is the FIRST post-drift adaptation's
        regret = next(((s.regret_hours, s.regret_frac) for s in self.swaps
                       if s.reason == "change-point"
                       and s.regret_hours is not None), None)
        return RuntimeReport(
            n_obs=self.obs, n_refits=self.tracker.n_refits,
            change_points=self.tracker.change_points,
            swaps=tuple(self.swaps), events=tuple(self.events),
            retries=dict(self.retries), degraded=self.degraded,
            stale_obs_total=self.stale_obs_total,
            adaptation_lag_obs=(self._adaptation_lags[0]
                                if self._adaptation_lags else None),
            regret_hours=None if regret is None else regret[0],
            regret_frac=None if regret is None else regret[1],
            vm_hours_streamed=self.vm_hours_streamed,
            dollars_streamed=self.dollars_streamed,
            mean_price=(self.dollars_streamed / self.vm_hours_streamed
                        if self.vm_hours_streamed > 0 else None))

    def evaluate(self, **kw) -> list:
        """Re-run the standing policy sweep from the CURRENT live tables:
        one executor run, no re-solve."""
        cfg = self.cfg
        kw.setdefault("job_steps", cfg.job_steps)
        kw.setdefault("grid_dt", cfg.grid_dt)
        kw.setdefault("delta_steps", cfg.delta_steps)
        kw.setdefault("restart_overhead", cfg.restart_overhead)
        kw.setdefault("max_restarts", cfg.max_restarts)
        kw.setdefault("device", self.device)
        return SC.sweep_checkpointing(self.scenario_names,
                                      tables=self.live_tables, **kw)
