"""Spot-market prices and capacity crunches: the dollar side of the
checkpointing sweep (port of ``repro.core.market``).

* :class:`PriceProcess` - a seeded mean-reverting OU process on log price
  per (zone, vm_type) scenario leaf, with scheduled capacity-crunch
  episodes; a ``distributions`` dataclass, so ``distributions.stack`` /
  ``unstack`` give its fields the ``(S,)`` scenario axis.
* :func:`crunch_effective` - a crunch scales Eq. 1's ``A`` up and ``tau1``
  down through ``distributions.capped_constrained``, the same properness
  cap the launch-phase modulation uses.
* :class:`PriceGrid` - the ``(S, T)`` price grid and its cumulative-dollar
  grid ``cum[s, k] = sum_{i<k} prices[s, i] * dt``, host numpy float64,
  computed once and gathered by both cost paths.
* :func:`integrate_cost_ref` - the serial dollar integral of one trial;
  ``engine.accumulate_price_cost`` reproduces it to the bit.
* :class:`MarketModel` / :class:`PriceFeed` - the sweep's per-scenario
  processes on one (horizon, dt, seed) grid, and a live ticker that
  extends one trace lazily.

Traces and grids are input data: they are drawn and summed on the host in
numpy float64 from ``SeedSequence([seed, leaf])`` streams, in ``repro``'s
order, so they are bit-identical to ``repro``'s.  Billing convention: a VM
starting at ``t`` pays ``integral_t^{t+m} p(u) du`` along the trace, the
tail beyond the horizon at the last cell's price.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from . import distributions as dists
from .distributions import _dist

__all__ = [
    "PriceProcess", "PriceGrid", "MarketModel", "PriceFeed",
    "spot_price_process", "crunch_effective", "crunch_profile",
    "price_trace", "integrate_cost_ref", "MARKET_ZONE_PARAMS",
    "DEFAULT_HORIZON_HOURS", "DEFAULT_PRICE_DT",
]

DEFAULT_HORIZON_HOURS = 48.0
DEFAULT_PRICE_DT = 0.1          # price-grid resolution (hours)

# Zone price levels relative to the type's base preemptible price: a tighter
# market clears at a premium, a slacker one at a discount.
MARKET_ZONE_PARAMS = {
    "us-east1-b": dict(price_scale=1.00),
    "us-central1-a": dict(price_scale=1.12),
    "europe-west1-d": dict(price_scale=0.94),
}


@_dist
class PriceProcess:
    """Mean-reverting OU log-price with scheduled capacity-crunch episodes.

    ``log p`` follows the exact OU discretization ``x_{k+1} = mu + (x_k -
    mu) * e^{-theta*dt} + sd(dt) * z_k`` and the published price is
    ``exp(x + crunch_amp * c(t))`` with ``c(t)`` the crunch intensity.  At
    full intensity a crunch scales Eq. 1's ``A`` by ``crunch_A`` and
    ``tau1`` by ``crunch_tau1`` (:func:`crunch_effective`).  Fields are
    floats, or tensors after ``distributions.stack``; the host methods read
    them with ``float``.
    """

    mu: float = -2.0            # long-run mean log price (log USD/h)
    sigma: float = 0.08         # OU volatility (log-price units)
    theta: float = 0.35         # mean-reversion rate (1/h)
    p0: float = 0.135           # initial price (USD/h)
    crunch_t0: float = 0.0      # crunch window start (h); t1 <= t0 disables
    crunch_t1: float = 0.0      # crunch window end (h)
    crunch_period: float = 0.0  # repeat period (h); 0 = single episode
    crunch_amp: float = 0.9     # log-price lift at full crunch
    crunch_A: float = 1.6       # Eq. 1 A scale at full crunch
    crunch_tau1: float = 0.6    # Eq. 1 tau1 scale at full crunch

    @property
    def crunched(self) -> bool:
        """Whether a crunch window is scheduled (``t1 > t0``)."""
        return float(self.crunch_t1) > float(self.crunch_t0)

    def crunch_intensity(self, t):
        """Crunch indicator in [0, 1] at wall-clock hour(s) ``t``."""
        c0, c1, per = (float(self.crunch_t0), float(self.crunch_t1),
                       float(self.crunch_period))
        t = np.asarray(t, np.float64)
        if c1 <= c0:
            return np.zeros_like(t)
        tt = np.mod(t, per) if per > 0 else t
        return ((tt >= c0) & (tt < c1)).astype(np.float64)


def crunch_profile(proc: PriceProcess, times) -> np.ndarray:
    """``proc.crunch_intensity`` over an array of wall-clock hours."""
    return proc.crunch_intensity(np.asarray(times, np.float64))


def crunch_effective(dist, proc: PriceProcess, t_launch: float = 0.0):
    """The crunch -> Eq. 1 early-hazard coupling, resolved at VM launch:
    the crunch intensity ``c`` at launch scales ``A`` by
    ``1 + (crunch_A - 1) * c`` and ``tau1`` by ``1 - (1 - crunch_tau1) *
    c`` through ``distributions.capped_constrained``; ``c = 0`` passes the
    launch-resolved base model through unchanged."""
    base = dist.effective() if hasattr(dist, "effective") else dist
    c = float(proc.crunch_intensity(float(t_launch)))
    A_scale = 1.0 + (float(proc.crunch_A) - 1.0) * c
    tau1_scale = 1.0 - (1.0 - float(proc.crunch_tau1)) * c
    return dists.capped_constrained(base, A_scale=A_scale,
                                    tau1_scale=tau1_scale)


def price_trace(proc: PriceProcess, *, horizon: float = DEFAULT_HORIZON_HOURS,
                dt: float = DEFAULT_PRICE_DT, seed: int = 0,
                leaf: int = 0) -> np.ndarray:
    """One deterministic ``(T,)`` price trace (USD/h, host float64) from the
    noise stream ``default_rng(SeedSequence([seed, leaf]))``: one
    reproducible stream per (sweep seed, scenario leaf)."""
    T = int(round(horizon / dt))
    if T < 1:
        raise ValueError(f"horizon/dt gives an empty grid ({horizon}/{dt})")
    mu, sigma, theta = float(proc.mu), float(proc.sigma), float(proc.theta)
    p0 = float(proc.p0)
    if p0 <= 0.0:
        raise ValueError(f"p0 must be positive, got {p0}")
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(leaf)]))
    z = rng.standard_normal(T - 1)
    a = np.exp(-theta * dt)
    sd = (sigma * np.sqrt((1.0 - a * a) / (2.0 * theta)) if theta > 0
          else sigma * np.sqrt(dt))
    x = np.empty(T, np.float64)
    x[0] = np.log(p0)
    for k in range(T - 1):
        x[k + 1] = mu + (x[k] - mu) * a + sd * z[k]
    c = crunch_profile(proc, dt * np.arange(T, dtype=np.float64))
    return np.exp(x + float(proc.crunch_amp) * c)


def spot_price_process(zone: str = "us-east1-b",
                       vm_type: str = "n1-highcpu-16",
                       **overrides) -> PriceProcess:
    """The catalog (zone, vm_type) leaf: the preemptible list price scaled
    by the zone's market level, as both the initial price and the OU
    long-run mean; ``overrides`` set any :class:`PriceProcess` field."""
    from .service import PRICES_PREEMPTIBLE
    base = (PRICES_PREEMPTIBLE[vm_type]
            * MARKET_ZONE_PARAMS[zone]["price_scale"])
    kw = dict(mu=np.log(base), p0=base)
    kw.update(overrides)
    return PriceProcess(**kw)


@dataclasses.dataclass(frozen=True)
class PriceGrid:
    """``prices[s, k]``: leaf ``s``'s price on ``[k*dt, (k+1)*dt)``;
    ``cum[s, k]``: the dollars of one VM over ``[0, k*dt)``.  Host numpy
    float64; the cumulative sum's order is part of the cost paths' bit
    contract, so it is computed here once.  :meth:`shift` re-anchors the
    grid at a later launch; cells beyond the horizon bill at the last
    cell's price."""
    prices: np.ndarray           # (S, T) float64
    cum: np.ndarray              # (S, T+1) float64
    dt: float

    @staticmethod
    def from_prices(prices, dt: float) -> "PriceGrid":
        prices = np.atleast_2d(np.asarray(prices, np.float64))
        if not np.all(prices > 0.0):
            raise ValueError("price grid must be strictly positive")
        cum = np.zeros((prices.shape[0], prices.shape[1] + 1), np.float64)
        np.cumsum(prices * dt, axis=1, out=cum[:, 1:])
        return PriceGrid(prices=prices, cum=cum, dt=float(dt))

    @property
    def horizon(self) -> float:
        return self.prices.shape[1] * self.dt

    def __len__(self) -> int:
        return self.prices.shape[0]

    def shift(self, t0: float) -> "PriceGrid":
        """The grid as seen from launch time ``t0``: row ``k`` becomes row
        ``k0 + k`` (clamped to the last cell)."""
        k0 = int(np.floor(float(t0) / self.dt))
        T = self.prices.shape[1]
        idx = np.minimum(np.arange(T) + max(k0, 0), T - 1)
        return PriceGrid.from_prices(self.prices[:, idx], self.dt)

    def price_at(self, t) -> np.ndarray:
        """``(S,)`` prices at wall-clock hour ``t`` (tail-clamped)."""
        k = min(int(np.floor(float(t) / self.dt)), self.prices.shape[1] - 1)
        return self.prices[:, max(k, 0)]


def integrate_cost_ref(prices_row, cum_row, dt: float, makespan) -> float:
    """The serial dollar integral ``integral_0^m p`` of one trial: scalar
    float64 ``cum[k] + prices[k] * (m - k*dt)`` with ``k = floor(m/dt)``
    clamped to the last cell; a NaN makespan (an unfinished trial) gives
    NaN dollars."""
    m = float(makespan)
    if np.isnan(m):
        return float("nan")
    T = len(prices_row)
    k = min(max(int(np.floor(m / dt)), 0), T - 1)
    base = np.float64(cum_row[k])
    frac = np.float64(m) - np.float64(k) * np.float64(dt)
    return float(base + np.float64(prices_row[k]) * frac)


@dataclasses.dataclass
class MarketModel:
    """Per-scenario price processes on one (horizon, dt, seed) grid:
    ``processes[s]`` prices scenario leaf ``s`` (the leaf order IS the
    scenario order); :meth:`grid` builds and caches the ``(S, T)``
    :class:`PriceGrid`."""
    processes: list
    horizon: float = DEFAULT_HORIZON_HOURS
    dt: float = DEFAULT_PRICE_DT
    seed: int = 0
    _grid: Optional[PriceGrid] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def for_scenarios(cls, scenarios: Sequence, *,
                      crunch_zones: Sequence[str] = ("us-central1-a",),
                      crunch_window: tuple = (8.0, 16.0),
                      crunch_amp: float = 0.9, crunch_A: float = 1.6,
                      crunch_tau1: float = 0.6,
                      horizon: float = DEFAULT_HORIZON_HOURS,
                      dt: float = DEFAULT_PRICE_DT, seed: int = 0,
                      **proc_overrides) -> "MarketModel":
        """One catalog leaf per scenario, with a crunch episode on every
        leaf whose zone is in ``crunch_zones``."""
        procs = []
        for sc in scenarios:
            kw = dict(proc_overrides)
            if sc.zone in crunch_zones:
                kw.update(crunch_t0=crunch_window[0],
                          crunch_t1=crunch_window[1],
                          crunch_amp=crunch_amp, crunch_A=crunch_A,
                          crunch_tau1=crunch_tau1)
            procs.append(spot_price_process(sc.zone, sc.vm_type, **kw))
        return cls(processes=procs, horizon=horizon, dt=dt, seed=seed)

    def __len__(self) -> int:
        return len(self.processes)

    def grid(self) -> PriceGrid:
        if self._grid is None:
            rows = np.stack([
                price_trace(p, horizon=self.horizon, dt=self.dt,
                            seed=self.seed, leaf=i)
                for i, p in enumerate(self.processes)])
            self._grid = PriceGrid.from_prices(rows, self.dt)
        return self._grid

    def launch_time(self, regime: str) -> float:
        """The launch hour a regime evaluates at: ``"calm"`` at hour 0,
        ``"crunch"`` at the first scheduled episode's start (hour 0 when no
        leaf schedules one)."""
        if regime == "calm":
            return 0.0
        if regime == "crunch":
            starts = [float(p.crunch_t0) for p in self.processes
                      if p.crunched]
            return min(starts) if starts else 0.0
        raise ValueError(f"regime must be 'calm' or 'crunch', got {regime!r}")

    def crunch_dists(self, scenarios: Sequence, t_launch: float) -> list:
        """Per-leaf crunch-coupled Eq. 1 models at launch time."""
        return [crunch_effective(sc.dist(), p, t_launch)
                for sc, p in zip(scenarios, self.processes)]


class PriceFeed:
    """A live ticker: one :class:`PriceProcess` advanced ``tick_hours`` per
    observation, its trace extended lazily in ``block`` cells and
    deterministic per seed, so a replayed run bills identically."""

    def __init__(self, process: Optional[PriceProcess] = None, *,
                 seed: int = 0, dt: float = DEFAULT_PRICE_DT,
                 tick_hours: float = 0.05, block: int = 512):
        self.process = process or spot_price_process()
        self.seed = int(seed)
        self.dt = float(dt)
        self.tick_hours = float(tick_hours)
        self.block = int(block)
        self.clock_hours = 0.0
        self._trace = np.empty((0,), np.float64)

    def _ensure(self, k: int) -> None:
        while k >= len(self._trace):
            cells = len(self._trace) + self.block
            # the whole prefix is redrawn: price_trace is deterministic per
            # (seed, leaf), so extending never rewrites history
            self._trace = price_trace(self.process,
                                      horizon=cells * self.dt, dt=self.dt,
                                      seed=self.seed, leaf=0)

    def price_at(self, hours: float) -> float:
        k = max(int(np.floor(float(hours) / self.dt)), 0)
        self._ensure(k)
        return float(self._trace[k])

    def grid(self, horizon_hours: float) -> PriceGrid:
        """A one-row :class:`PriceGrid` of the next ``horizon_hours`` seen
        from the current clock: the forecast a dollar-objective refit
        solves against (the same clock always gives the same grid)."""
        n = max(int(np.ceil(float(horizon_hours) / self.dt)), 1)
        k0 = max(int(np.floor(self.clock_hours / self.dt)), 0)
        self._ensure(k0 + n - 1)
        return PriceGrid.from_prices(self._trace[k0:k0 + n][None, :], self.dt)

    def current(self) -> float:
        return self.price_at(self.clock_hours)

    def advance(self) -> float:
        """Price at the current clock, then tick forward one observation."""
        p = self.current()
        self.clock_hours += self.tick_hours
        return p
