"""Monte-Carlo makespan executor and lifetime pools, in PyTorch (the
checkpointing half of ``repro.core.engine``).

Policies are integer tables ``P[j, t] -> interval`` (steps until the next
checkpoint given ``j`` remaining steps and VM age index ``t``); the
age-independent Young-Daly and no-checkpoint policies are ``(j_max+1, 1)``
columns.  :func:`simulate_makespan_batch` runs every cell of a sweep as one
lane of one event loop on the device, in float64: work is counted in
integer grid steps and the only float accumulation is the sum of preempted
partial segments, so on a shared pool each lane performs the same IEEE
operations as ``repro``'s executor under x64 and the makespans agree to the
bit.  Pools are drawn from ``numpy.random.default_rng`` uniforms in
``repro``'s order and inverted on the device: :func:`draw_lifetime_pool`
for one sampler (``checkpointing.model_lifetimes_fn``),
:func:`draw_lifetime_pool_batch` for a list of cells, both through
:func:`capped_model_draw`; :func:`simulate_makespan_engine` is the draw
followed by the executor.  :class:`ReuseTables` holds
the batch service's reuse decisions for every scenario, evaluated in one
call on the device, with a host copy for the serial event loop.
:func:`accumulate_price_cost` bills makespans against a market price grid,
to the bit of the serial ``market.integrate_cost_ref``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from . import distributions as dists_mod
from .policies import scheduling as sched_policy

__all__ = [
    "dp_policy_table", "young_daly_policy_table", "no_checkpoint_policy_table",
    "validate_policy_table", "stack_policy_tables",
    "capped_icdf_draw", "capped_model_draw",
    "draw_lifetime_pool", "draw_lifetime_pool_batch",
    "accumulate_price_cost",
    "simulate_makespan_batch", "simulate_makespan_engine",
    "ReuseTable", "ReuseTables",
]

_F64 = torch.float64

# events run between two host checks of "is any trial still running";
# the extra iterations after the last trial finishes change nothing
_CHECK_EVERY = 8


def _on(x, device, dtype):
    """``x`` (tensor or array-like) as a ``dtype`` tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# policy tables
# ---------------------------------------------------------------------------

def dp_policy_table(tables) -> torch.Tensor:
    """The DP's optimal-interval table ``K[j, t]``."""
    return tables.K.to(torch.int32)


def young_daly_policy_table(tau_steps: int, job_steps: int) -> np.ndarray:
    """Fixed-interval policy ``min(tau, remaining)`` as a (j_max+1, 1)
    table."""
    j = np.arange(job_steps + 1, dtype=np.int32)
    return np.minimum(np.maximum(int(tau_steps), 1), j)[:, None].astype(
        np.int32)


def no_checkpoint_policy_table(job_steps: int) -> np.ndarray:
    """Run-to-completion: the next 'segment' is the whole remaining job."""
    return np.arange(job_steps + 1, dtype=np.int32)[:, None]


def validate_policy_table(table) -> np.ndarray:
    """Reject a policy table the executor must never serve from: non-finite
    entries, intervals outside ``[0, j]`` or zero with work remaining.
    Returns the table as host int32; raises ValueError."""
    raw = (table.cpu().numpy() if isinstance(table, torch.Tensor)
           else np.asarray(table))
    if not np.all(np.isfinite(raw)):
        raise ValueError("validate_policy_table: non-finite entries")
    t = raw.astype(np.int32)
    if t.ndim != 2:
        raise ValueError(f"validate_policy_table: expected a 2-D (j, t) "
                         f"table, got shape {raw.shape}")
    j = np.arange(t.shape[0], dtype=np.int32)[:, None]
    if np.any(t < 0) or np.any(t > j):
        raise ValueError("validate_policy_table: intervals outside [0, j]")
    if t.shape[0] > 1 and np.any(t[1:] < 1):
        raise ValueError("validate_policy_table: zero interval with work "
                         "remaining (j >= 1)")
    return t


def stack_policy_tables(tables, t_axis: int | None = None, *,
                        device="cuda") -> torch.Tensor:
    """Stack per-cell 2-D policy tables (numpy arrays or tensors) into one
    ``(B, j_max+1, t_axis)`` int32 tensor on ``device``.  A 1-wide
    age-independent column is replicated across the age axis, which
    changes no lookup; any other width mismatch is rejected."""
    dev = resolve_device(device)
    tables = [_on(t, dev, torch.int32) for t in tables]
    if not tables:
        raise ValueError("stack_policy_tables() needs at least one table")
    if any(t.ndim != 2 for t in tables):
        raise ValueError("stack_policy_tables() stacks 2-D (j, t) tables")
    j_axis = tables[0].shape[0]
    if any(t.shape[0] != j_axis for t in tables):
        raise ValueError("policy tables must share the remaining-work axis; "
                         f"got {sorted({t.shape[0] for t in tables})}")
    if t_axis is None:
        t_axis = max(t.shape[1] for t in tables)
    out = torch.empty((len(tables), j_axis, int(t_axis)), dtype=torch.int32,
                      device=dev)
    for b, t in enumerate(tables):
        if t.shape[1] not in (1, t_axis):
            raise ValueError(
                f"table {b} has age axis {t.shape[1]}; expected 1 (age-"
                f"independent) or {t_axis} — widening an age-dependent "
                f"table would need resampling, not replication")
        out[b] = t.expand(j_axis, int(t_axis))
    return out


# ---------------------------------------------------------------------------
# lifetime pools
# ---------------------------------------------------------------------------

def capped_icdf_draw(dist, u, fl, L):
    """Lifetimes ``icdf(min(u, fl * (1 - 1e-6)))``, with the residual
    ``u >= fl`` mass preempted AT the deadline ``L``.  ``fl`` and ``L``
    broadcast against ``u`` (scalars, or ``(S, 1)`` beside a stacked
    distribution)."""
    t = dist.icdf(torch.minimum(u, fl * (1.0 - 1e-6)))
    return torch.where(u >= fl, torch.as_tensor(L, dtype=t.dtype,
                                                 device=t.device), t)


def capped_model_draw(dists, u, *, min_age: float = 0.0, device="cuda"):
    """Lifetimes from uniforms ``u`` ``(S, n)``, row ``s`` inverted under
    ``dists[s]``: restricted to ``[F(min_age), 1]`` when ``min_age > 0``
    (survival to ``min_age``), then :func:`capped_icdf_draw`.

    Each model is launch-resolved (``effective()``) and the list stacked to
    ``(S, 1)`` fields on ``device``, with ``F(min_age)``, ``F(L)`` and
    ``L`` as ``(S, 1)`` device tensors, so a model drawn alone (S = 1)
    evaluates the same expressions on the same operand kinds as inside a
    batch, and its rows are bit-identical to the batch's."""
    dev = resolve_device(device)
    eff = [d.effective() if hasattr(d, "effective") else d for d in dists]
    stacked = dists_mod.stack(eff, device=dev)
    d_b = dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name)[:, None]
        for f in dataclasses.fields(stacked)})

    def col(fn):
        return torch.tensor([[float(fn(d))] for d in eff], dtype=_F64,
                            device=dev)
    if min_age > 0:
        f_lo = col(lambda d: d.cdf(min_age))
        u = f_lo + u * (1.0 - f_lo)
    return capped_icdf_draw(d_b, u, col(lambda d: d.cdf(d.L)),
                            col(lambda d: d.L))


def _f64_tensor(x):
    """A sampler's output as a float64 tensor (a tensor keeps its device)."""
    if isinstance(x, torch.Tensor):
        return x.to(_F64)
    return torch.from_numpy(np.array(x, np.float64))


def draw_lifetime_pool(lifetimes_fn, n_trials: int, *, max_restarts: int = 64,
                       seed: int = 0, start_age: float = 0.0):
    """The ``(first, pool)`` lifetimes of one executor run, as float64
    tensors on the sampler's device (the CPU for a sampler that returns
    arrays).

    ``lifetimes_fn(rng, n, min_age=0.0)`` follows ``repro``'s protocol
    (``checkpointing.model_lifetimes_fn``).  From ``default_rng(seed)`` it
    draws the ``(n_trials, max_restarts + 2)`` pool block first, then
    ``first`` conditioned on survival to ``start_age``; a sampler without
    ``min_age`` gets ``first = pool[:, 0]``.  Draw ``k >= 1`` after the
    k-th preemption of trial ``n`` is ``pool[n, min(k, max_restarts + 1)]``.
    """
    rng = np.random.default_rng(seed)
    pool = _f64_tensor(lifetimes_fn(rng, n_trials * (max_restarts + 2)))
    pool = pool.reshape(n_trials, max_restarts + 2)
    try:
        first = _f64_tensor(lifetimes_fn(rng, n_trials, min_age=start_age))
    except TypeError:  # sampler without conditioning support
        first = pool[:, 0].clone()
    return first, pool


def draw_lifetime_pool_batch(dists, n_trials: int, *, max_restarts: int = 64,
                             seed=0, start_age: float = 0.0, device="cuda"):
    """Lifetime pools for a list of cells: ``first`` ``(S, n_trials)`` and
    ``pool`` ``(S, n_trials, max_restarts + 2)``, float64 on ``device``.

    ``seed`` is one integer (every entry shares its uniforms) or one seed
    per entry.  Each entry's uniforms come from its own
    ``np.random.default_rng(seed)`` stream in ``repro``'s order (pool
    block, then the first draws), drawn once per unique seed; the inverse
    CDF runs on the device over all entries at once
    (:func:`capped_model_draw`), so entry ``s`` equals
    ``draw_lifetime_pool(model_lifetimes_fn(dists[s]), ...)`` to the bit."""
    dev = resolve_device(device)
    dists = list(dists)
    S = len(dists)
    n_pool = n_trials * (max_restarts + 2)
    if np.ndim(seed) == 0:
        rng = np.random.default_rng(seed)
        u_pool = torch.as_tensor(rng.uniform(size=n_pool),
                                 device=dev).expand(S, n_pool)
        u_first = torch.as_tensor(rng.uniform(size=n_trials),
                                  device=dev).expand(S, n_trials)
    else:
        seed = list(seed)
        if len(seed) != S:
            raise ValueError(f"per-entry seeds need one seed per entry: got "
                             f"{len(seed)} seeds for {S} distributions")
        draws, order = {}, []
        for s in seed:
            if s not in draws:
                r = np.random.default_rng(s)
                draws[s] = (len(order), r.uniform(size=n_pool),
                            r.uniform(size=n_trials))
                order.append(s)
        rows = torch.as_tensor([draws[s][0] for s in seed], device=dev)
        u_pool = torch.as_tensor(np.stack([draws[s][1] for s in order]),
                                 device=dev)[rows]
        u_first = torch.as_tensor(np.stack([draws[s][2] for s in order]),
                                  device=dev)[rows]
    pool = capped_model_draw(dists, u_pool, device=dev)
    first = capped_model_draw(dists, u_first, min_age=start_age, device=dev)
    return first, pool.reshape(S, n_trials, max_restarts + 2)


# ---------------------------------------------------------------------------
# market dollars: the price-grid gather
# ---------------------------------------------------------------------------

def accumulate_price_cost(grid, makespans, price_index=None,
                          device="cuda") -> np.ndarray:
    """Dollars per trial for ``(B, n_trials)`` makespans (hours) billed
    against a ``market.PriceGrid``: lane ``b`` integrates price row
    ``price_index[b]`` (identity when omitted) over ``[0, m)``.  NaN
    makespans (unfinished trials) stay NaN.

    The cell index ``k = floor(m / dt)`` (tail-clamped) and the gathers
    ``cum[s, k]``, ``prices[s, k]`` run on ``device`` in float64, ``dt`` a
    device tensor (CUDA divides by a host scalar as a product with its
    reciprocal, which moves ``k`` at cell edges).  The partial-cell
    arithmetic ``cum + prices * (m - k*dt)`` runs in host numpy float64,
    the rounding sequence of ``market.integrate_cost_ref``, so every
    element equals it to the bit."""
    dev = resolve_device(device)
    m = np.atleast_2d(np.asarray(makespans, np.float64))
    B = m.shape[0]
    if price_index is None:
        price_index = np.arange(B, dtype=np.int64)
    sidx = np.broadcast_to(np.asarray(price_index, np.int64), (B,))
    if sidx.size and (sidx.min() < 0 or sidx.max() >= len(grid.prices)):
        raise ValueError("price_index out of range for the price grid")
    prices = torch.as_tensor(np.asarray(grid.prices, np.float64), device=dev)
    cum = torch.as_tensor(np.asarray(grid.cum, np.float64), device=dev)
    m_d = torch.as_tensor(m, device=dev)
    dt = torch.tensor(float(grid.dt), dtype=_F64, device=dev)
    m0 = torch.where(torch.isnan(m_d), 0.0, m_d)
    k = torch.clamp(torch.floor(m0 / dt).to(torch.int64), 0,
                    prices.shape[1] - 1)
    s = torch.as_tensor(np.array(sidx), device=dev)[:, None]
    base = cum[s, k].cpu().numpy()
    pk = prices[s, k].cpu().numpy()
    kf = k.cpu().numpy().astype(np.float64)
    frac = m - kf * np.float64(grid.dt)
    out = base + pk * frac
    out[np.isnan(m)] = np.nan
    return out if np.ndim(makespans) > 1 else out[0]


# ---------------------------------------------------------------------------
# the event loop
# ---------------------------------------------------------------------------

def _event_loop(table, tix, pool_steps, pix, first_steps, job_steps,
                age0_idx, delta_steps, max_restarts, max_events):
    """THE makespan event loop over ``(B, n_trials)`` lanes: lane ``b``
    reads its policy from ``table[tix[b]]`` and its lifetimes from
    ``pool_steps[pix[b]]``.  One iteration is one work-segment attempt for
    every running trial; trials that finished or ran out of restarts are
    frozen.  Returns ``(done_steps, lost_steps, restarts, finished)``."""
    B, n = first_steps.shape
    _, J1, Tt = table.shape
    M = pool_steps.shape[2]
    dev = first_steps.device
    flat_table = table.reshape(-1)
    flat_pool = pool_steps.reshape(-1)
    tbase = (tix * (J1 * Tt))[:, None]
    pbase = (pix[:, None] * n + torch.arange(n, device=dev)[None, :]) * M
    rem = torch.full((B, n), int(job_steps), dtype=torch.int64, device=dev)
    age = torch.full((B, n), int(age0_idx), dtype=torch.int64, device=dev)
    draw = torch.zeros((B, n), dtype=torch.int64, device=dev)
    life = first_steps.clone()
    done = torch.zeros((B, n), dtype=torch.int64, device=dev)
    lost = torch.zeros((B, n), dtype=_F64, device=dev)
    restarts = torch.zeros((B, n), dtype=torch.int64, device=dev)

    def active():
        return (rem > 0) & (restarts <= max_restarts)

    events = 0
    while events < max_events and bool(active().any()):
        for _ in range(min(_CHECK_EVERY, max_events - events)):
            act = active()
            i = flat_table[tbase + torch.clamp(rem, 0, J1 - 1) * Tt
                           + torch.clamp(age, 0, Tt - 1)]
            i = torch.minimum(torch.clamp(i, min=1), torch.clamp(rem, min=1))
            w = torch.where(i < rem, i + delta_steps, i)
            survive = (age + w).to(_F64) <= life
            # preemption: time since VM start minus checkpointed prefix
            loss = torch.clamp(life - age.to(_F64), min=0.0)
            nxt_draw = draw + 1
            nxt_life = flat_pool[pbase + torch.clamp(nxt_draw,
                                                     max=max_restarts + 1)]
            ok = act & survive
            bad = act & ~survive
            rem = torch.where(ok, rem - i, rem)
            age = torch.where(ok, age + w, torch.where(bad, 0, age))
            draw = torch.where(bad, nxt_draw, draw)
            life = torch.where(bad, nxt_life, life)
            done = torch.where(ok, done + w, done)
            lost = torch.where(bad, lost + loss, lost)
            restarts = torch.where(bad, restarts + 1, restarts)
            events += 1
    return done, lost, restarts, rem == 0


def simulate_makespan_batch(policy_table, job_steps: int, *, first, pool,
                            grid_dt: float = 1.0 / 60.0, delta_steps: int = 1,
                            start_age: float = 0.0,
                            restart_overhead: float = 0.0,
                            max_restarts: int = 64,
                            max_events: int | None = None,
                            unfinished: str = "nan",
                            return_finished: bool = False,
                            table_index=None, pool_index=None,
                            device="cuda"):
    """Execute jobs under pre-drawn lifetimes; returns host float64
    makespans (hours).

    A preemption mid-segment (work or checkpoint write) loses progress back
    to the last durable checkpoint and the job resumes on a fresh VM after
    ``restart_overhead`` hours.  ``pool`` is ``(n_trials, max_restarts+2)``
    with ``first`` ``(n_trials,)`` and a 2-D ``policy_table``, or has a
    leading cell axis ``(B, ...)`` with ``first`` ``(B, n_trials)`` and a
    per-cell ``(B, j, t)`` or shared 2-D table; the result then has the
    same leading axis.  ``table_index``/``pool_index`` (shape ``(B,)``)
    instead map each of the B lanes to a ``(U, j, t)`` table of unique
    tables and a ``(Q, n_trials, max_restarts+2)`` pool of unique pools.

    Trials that exhaust ``max_restarts`` (or the ``max_events`` cap) are
    reported per ``unfinished``: ``"nan"`` (default), ``"partial"`` (the
    accumulated time) or ``"raise"``.  ``return_finished=True`` also
    returns the completion mask.
    """
    if unfinished not in ("nan", "partial", "raise"):
        raise ValueError(f"unfinished must be 'nan', 'partial' or 'raise', "
                         f"got {unfinished!r}")
    dev = resolve_device(device)
    if max_events is None:
        max_events = int(job_steps) + int(max_restarts) + 2
    age0_idx = int(round(start_age / grid_dt))
    off0 = start_age - age0_idx * grid_dt
    # unit conversion in float64, rounded as the reference's numpy: the
    # divisor is a device tensor because CUDA divides by a host scalar as a
    # multiplication by its reciprocal, which rounds differently
    gdt = torch.tensor(grid_dt, dtype=_F64, device=dev)
    first_steps = (_on(first, dev, _F64) - off0) / gdt
    pool_steps = _on(pool, dev, _F64) / gdt
    table = _on(policy_table, dev, torch.int64)
    if (table_index is None) != (pool_index is None):
        raise ValueError("table_index and pool_index must be passed together")
    single = False
    if table_index is not None:
        tix = torch.as_tensor(np.asarray(table_index), dtype=torch.int64,
                              device=dev)
        pix = torch.as_tensor(np.asarray(pool_index), dtype=torch.int64,
                              device=dev)
        if table.ndim != 3 or pool_steps.ndim != 3:
            raise ValueError("the indexed fold needs a (U, j, t) policy_table "
                             "and a (Q, n_trials, max_restarts + 2) pool")
        if first_steps.ndim != 2 \
                or not (tix.shape == pix.shape == first_steps.shape[:1]) \
                or first_steps.shape[1] != pool_steps.shape[1]:
            raise ValueError(
                f"indexed fold needs first of shape (B, n_trials) with "
                f"(B,) table_index/pool_index and a matching pool trial "
                f"axis; got first {tuple(first_steps.shape)}, pool "
                f"{tuple(pool_steps.shape)}, table_index {tuple(tix.shape)}, "
                f"pool_index {tuple(pix.shape)}")
        if tix.numel() and (int(tix.min()) < 0
                            or int(tix.max()) >= table.shape[0]):
            raise ValueError("table_index out of range")
        if pix.numel() and (int(pix.min()) < 0
                            or int(pix.max()) >= pool_steps.shape[0]):
            raise ValueError("pool_index out of range")
    elif pool_steps.ndim == 3:                   # leading cell axis
        B = pool_steps.shape[0]
        if tuple(first_steps.shape) != tuple(pool_steps.shape[:2]):
            raise ValueError(
                f"scenario-batched pool {tuple(pool_steps.shape)} needs first "
                f"of shape {tuple(pool_steps.shape[:2])}, got "
                f"{tuple(first_steps.shape)}")
        pix = torch.arange(B, device=dev)
        if table.ndim == 3:
            if table.shape[0] != B:
                raise ValueError(f"per-cell policy_table has "
                                 f"{table.shape[0]} tables for {B} cells")
            tix = pix
        else:
            table, tix = table[None], torch.zeros_like(pix)
    elif table.ndim == 3:
        raise ValueError("per-scenario policy_table needs a scenario-batched "
                         "pool (S, n_trials, max_restarts + 2)")
    else:
        single = True
        table, pool_steps, first_steps = (table[None], pool_steps[None],
                                          first_steps[None])
        tix = pix = torch.zeros(1, dtype=torch.int64, device=dev)
    done, lost, restarts, finished = _event_loop(
        table, tix, pool_steps, pix, first_steps, job_steps, age0_idx,
        delta_steps, max_restarts, max_events)
    done = done.cpu().numpy().astype(np.float64)
    lost = lost.cpu().numpy()
    restarts = restarts.cpu().numpy().astype(np.float64)
    finished = finished.cpu().numpy()
    if single:
        done, lost, restarts, finished = done[0], lost[0], restarts[0], \
            finished[0]
    out = (done + lost) * grid_dt + restarts * restart_overhead
    if not finished.all():
        if unfinished == "raise":
            raise RuntimeError(
                f"{int((~finished).sum())}/{finished.size} trials exited "
                f"unfinished (max_restarts={max_restarts}, "
                f"max_events={max_events})")
        if unfinished == "nan":
            out = np.where(finished, out, np.nan)
    if return_finished:
        return out, finished
    return out


def simulate_makespan_engine(policy_table, lifetimes_fn, job_steps: int, *,
                             grid_dt: float = 1.0 / 60.0, delta_steps: int = 1,
                             start_age: float = 0.0, n_trials: int = 2000,
                             seed: int = 0, restart_overhead: float = 0.0,
                             max_restarts: int = 64, device="cuda", **kw):
    """The executor counterpart of ``checkpointing.simulate_makespan``: the
    same sampler protocol and seed give the same lifetimes
    (:func:`draw_lifetime_pool`), then :func:`simulate_makespan_batch` runs
    them on ``device``.  Extra keywords (``unfinished``,
    ``return_finished``, ``max_events``) pass through to it."""
    first, pool = draw_lifetime_pool(lifetimes_fn, n_trials,
                                     max_restarts=max_restarts, seed=seed,
                                     start_age=start_age)
    return simulate_makespan_batch(policy_table, job_steps, first=first,
                                   pool=pool, grid_dt=grid_dt,
                                   delta_steps=delta_steps,
                                   start_age=start_age,
                                   restart_overhead=restart_overhead,
                                   max_restarts=max_restarts, device=device,
                                   **kw)


# ---------------------------------------------------------------------------
# reuse decisions for the batch service
# ---------------------------------------------------------------------------

def _reuse_grid_batch(dists, T_values, L: float, n_age: int, device):
    """``(S, len(T_values), n_age)`` Eq. 10 < Eq. 9 decisions for a list of
    distributions, in one broadcast evaluation on ``device``.  Both sides
    are evaluated on full ``(S, T, n_age)`` operands, so at age 0 (where
    Eq. 10 and Eq. 9 are the same expression) every element takes the
    same arithmetic path on both sides and the tie stays a tie."""
    eff = [d.effective() if hasattr(d, "effective") else d for d in dists]
    stacked = dists_mod.stack(eff, device=device)
    d_b = dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name)[:, None, None]
        for f in dataclasses.fields(stacked)})
    shape = (len(eff), len(T_values), int(n_age))
    T = torch.as_tensor(T_values, dtype=_F64, device=device)
    age = torch.as_tensor(sched_policy.linspace(0.0, L, n_age), device=device)
    T = T[None, :, None].expand(shape).contiguous()
    age = age[None, None, :].expand(shape).contiguous()
    return sched_policy.reuse_decision(d_b, T, age)


class ReuseTable:
    """Precomputed reuse decisions over (remaining work x VM age) for one
    distribution.

    ``T_values`` is exact in the remaining-work axis; ages are quantized to
    ``n_age`` points over [0, L] (nearest), 1-min resolution by default.
    ``table`` is the host numpy copy the serial event loop reads through
    :meth:`decide`; ``tensor`` the same booleans on the device.
    """

    def __init__(self, dist, T_values, *, n_age: int = 1441,
                 device="cuda", _table=None):
        self.T_values = np.asarray(np.sort(np.unique(T_values)), np.float64)
        self.L = float(torch.as_tensor(dist.L).reshape(-1)[0])
        self.n_age = int(n_age)
        if _table is None:
            dev = resolve_device(device)
            _table = _reuse_grid_batch([dist], self.T_values, self.L,
                                       self.n_age, dev)[0]
        self.tensor = _table
        self.table = _table.cpu().numpy()

    def decide(self, remaining_work: float, vm_age: float) -> bool:
        ti = int(np.searchsorted(self.T_values, remaining_work))
        if ti >= len(self.T_values) or (
                ti > 0 and remaining_work - self.T_values[ti - 1]
                < self.T_values[ti] - remaining_work):
            ti -= 1
        ai = int(round(vm_age / self.L * (self.n_age - 1)))
        return bool(self.table[ti, min(max(ai, 0), self.n_age - 1)])


class ReuseTables:
    """Every scenario's reuse-decision grid as one ``(S, len(T_values),
    n_age)`` boolean tensor on the device (``tensor``), from ONE batched
    evaluation, with its host copy ``tables``; :meth:`view` (or indexing,
    iteration) gives per-scenario :class:`ReuseTable` views over them.  All
    scenarios must share the deadline ``L``."""

    def __init__(self, dists, T_values, *, n_age: int = 1441,
                 device="cuda"):
        dev = resolve_device(device)
        self._dists = list(dists)
        if not self._dists:
            raise ValueError("ReuseTables needs at least one distribution")
        Ls = [float(d.L) for d in self._dists]
        if any(abs(x - Ls[0]) > 1e-12 for x in Ls[1:]):
            raise ValueError("ReuseTables requires a shared L")
        self.T_values = np.asarray(np.sort(np.unique(T_values)), np.float64)
        self.L = Ls[0]
        self.n_age = int(n_age)
        self.tensor = _reuse_grid_batch(self._dists, self.T_values, self.L,
                                        self.n_age, dev)
        self.tables = self.tensor.cpu().numpy()

    def __len__(self) -> int:
        return len(self._dists)

    def view(self, s: int) -> ReuseTable:
        """A per-scenario :class:`ReuseTable` over the shared tensor."""
        return ReuseTable(self._dists[s], self.T_values, n_age=self.n_age,
                          _table=self.tensor[s])

    def __getitem__(self, s: int) -> ReuseTable:
        return self.view(s)

    def __iter__(self):
        return (self.view(s) for s in range(len(self)))
