"""Parity of the PyTorch port's checkpointing DP with ``repro``'s
``reference`` and ``xla`` backends (JAX under x64), on the CPU.

The port's plain recurrence (``dp_recurrence_plain``, which the kernel
wrapper also takes for CPU tensors) recomputes the failure probability and
the expected lost work in-lane, as the Pallas kernel does, so it is held
to the tolerance contract ``repro`` applies to that kernel: V within
rtol = atol = 1e-5, K agreement > 0.999 (makespan) or > 0.995 (dollars).
The CUDA kernel itself is held to this plain version on the card by
``chip_smoke.py``.
"""
import dataclasses
import random
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import distributions as D
from repro.core import market as M
from repro.core.policies import checkpointing as C
from repro.core.policies.solver_backends import grids as G
from repro_torch.core import carry
from repro_torch.core.policies import checkpointing as TC
from repro_torch.core.policies import solver_backends as TSB
from repro_torch.kernels.dp_recurrence import (dp_recurrence,
                                               dp_recurrence_plain)

RO = 0.3          # restart overhead (hours)
SIZES = [(24, 1.0 / 6.0), (60, 1.0 / 12.0)]
FAMILIES = ("constrained", "exponential", "weibull")


@pytest.fixture(scope="module")
def dists():
    return [D.constrained_for("n1-highcpu-16"), D.Exponential(mttf=8.0),
            D.Weibull(lam=0.12, k=0.8)]


@pytest.fixture(scope="module")
def tdists(dists):
    return [carry.dist_from_numpy(fam, {f.name: np.asarray(getattr(d, f.name))
                                        for f in dataclasses.fields(d)},
                                  device="cpu")
            for fam, d in zip(FAMILIES, dists)]


@pytest.fixture(scope="module")
def price():
    # flat / crunch spike / ramp, 15-min cells over 16 h
    n = 64
    flat = np.full(n, 0.12)
    spike = np.full(n, 0.10)
    spike[12:28] = 0.55
    ramp = np.linspace(0.08, 0.40, n)
    return M.PriceGrid.from_prices(np.stack([flat, spike, ramp]), 0.25)


def _np(x):
    return x.cpu().numpy()


def _assert_tables_close(V, K, ref, k_min):
    np.testing.assert_allclose(_np(V), np.asarray(ref.V), rtol=1e-5, atol=1e-5)
    assert (_np(K) == np.asarray(ref.K)).mean() > k_min


@pytest.mark.parametrize("job,grid_dt", SIZES)
@pytest.mark.parametrize("backend", ["reference", "xla"])
def test_plain_recurrence_on_shared_grids(dists, backend, job, grid_dt):
    """The port's plain backend fed JAX's own float32 grids."""
    with jax.enable_x64(True):
        ref = C.solve_batch(dists, job, grid_dt=grid_dt, restart_overhead=RO,
                            backend=backend)
        grids = [G.cdf_grids(d, grid_dt) for d in dists]
    Fc = torch.as_tensor(np.stack([np.asarray(g[0]) for g in grids]))
    Hc = torch.as_tensor(np.stack([np.asarray(g[1]) for g in grids]))
    V, K = TSB.get("reference").solve_tables_batch(
        Fc, Hc, grid_dt, RO, j_max=job, t_max=grids[0][2], delta_steps=1,
        n_sweeps=3)
    _assert_tables_close(V, K, ref, 0.999)


# Checkpoint delays.  At delta 0 a checkpoint is free, and in the flat
# middle of Eq. 1 (F ~ A to float32 precision, ages ~9-17 h) every split
# of the remaining work costs the same: the candidates tie to within
# float32 rounding and the argmin falls to the order of the float32 sums.
# The port's plain recurrence sums in the Pallas kernel's order, repro's
# backends in theirs, so ~1-1.5 % of the constrained scenario's argmins
# differ (K agreement 0.988-0.994 over the three scenarios here).  The
# delta-0 case therefore holds every differing K to a tie: re-evaluated in
# float64 on repro's V, the two choices cost the same within 1e-6
# relative (float32 rounding is 6e-8), and the agreement is >= 0.98.
DELTAS = [(1, 0.999), (2, 0.999), (5, 0.999), (0, 0.98)]


def _makespan_cost(F, H, V, R, j, t, i, grid_dt, t_max):
    """Float64 cost of candidate interval ``i`` at (j, t) at delta 0."""
    end = np.minimum(t + i, t_max)
    Ft, Fe = F[t], F[end]
    p_fail = np.clip((Fe - Ft) / np.maximum(1.0 - Ft, G._EPS), 0.0, 1.0)
    dF = np.maximum(Fe - Ft, G._EPS)
    e_lost = np.clip((H[end] - H[t]) / dF - t * grid_dt, 0.0, i * grid_dt)
    return (1.0 - p_fail) * (i * grid_dt + V[j - i, end]) \
        + p_fail * (e_lost + R[j])


def _flips_are_ties(dists, K, ref, grid_dt):
    with jax.enable_x64(True):
        grids = [G.cdf_grids(d, grid_dt) for d in dists]
    for s, (Fc, Hc, t_max) in enumerate(grids):
        F, H = np.asarray(Fc, np.float64), np.asarray(Hc, np.float64)
        V = np.asarray(ref.V[s], np.float64)
        Kr = np.asarray(ref.K[s])
        R = RO + V[:, 0]
        j, t = np.nonzero(K[s] != Kr)
        a = _makespan_cost(F, H, V, R, j, t, K[s][j, t], grid_dt, t_max)
        b = _makespan_cost(F, H, V, R, j, t, Kr[j, t], grid_dt, t_max)
        assert np.all(np.abs(a - b) <= 1e-6 * b), s


@pytest.mark.parametrize("delta,k_min", DELTAS)
@pytest.mark.parametrize("job,grid_dt", SIZES)
@pytest.mark.parametrize("backend", ["reference", "xla"])
def test_solve_batch_matches_jax(dists, tdists, backend, job, grid_dt, delta,
                                 k_min):
    with jax.enable_x64(True):
        ref = C.solve_batch(dists, job, grid_dt=grid_dt, restart_overhead=RO,
                            delta_steps=delta, backend=backend)
    got = TC.solve_batch(tdists, job, grid_dt=grid_dt, restart_overhead=RO,
                         delta_steps=delta, device="cpu")
    assert got.backend == "reference" and got.horizon_idx == ref.horizon_idx
    assert got.delta_steps == delta
    _assert_tables_close(got.V, got.K, ref, k_min)
    if delta == 0:
        _flips_are_ties(dists, _np(got.K), ref, grid_dt)
    got.validate()


@pytest.mark.parametrize("job,grid_dt", SIZES)
@pytest.mark.parametrize("backend", ["reference", "xla"])
def test_dollar_objective_matches_jax(dists, tdists, price, backend, job,
                                      grid_dt):
    kw = dict(grid_dt=grid_dt, restart_overhead=RO, objective="dollars",
              price=price)
    with jax.enable_x64(True):
        ref = C.solve_batch(dists, job, backend=backend, **kw)
    got = TC.solve_batch(tdists, job, device="cpu", **kw)
    assert got.objective == "dollars"
    _assert_tables_close(got.V, got.K, ref, 0.995)
    got.validate()


def test_warm_start_continues_the_sweeps(dists, tdists):
    """One warm sweep from a 2-sweep V lands on the 3-sweep solve: sweeps
    couple only through the restart column V[:, :, 0]."""
    kw = dict(grid_dt=1.0 / 6.0, restart_overhead=RO, device="cpu")
    cold2 = TC.solve_batch(tdists, 24, n_sweeps=2, **kw)
    warm = TC.solve_batch(tdists, 24, n_sweeps=1, v_init=cold2.V, **kw)
    cold3 = TC.solve_batch(tdists, 24, n_sweeps=3, **kw)
    np.testing.assert_allclose(_np(warm.V), _np(cold3.V), rtol=1e-5,
                               atol=1e-5)
    with jax.enable_x64(True):
        ref = C.solve_batch(dists, 24, grid_dt=1.0 / 6.0, restart_overhead=RO,
                            n_sweeps=1, v_init=_np(cold2.V))
    _assert_tables_close(warm.V, warm.K, ref, 0.999)
    with pytest.raises(ValueError, match="does not match"):
        TC.solve_batch(tdists, 24, n_sweeps=1, v_init=cold2.V[:2], **kw)
    bad = cold2.V.clone()
    bad[0, 1, 1] = float("nan")
    with pytest.raises(ValueError, match="non-finite warm start"):
        TC.solve_batch(tdists, 24, n_sweeps=1, v_init=bad, **kw)


def test_solve_equals_solve_batch_at_one_scenario(tdists, price):
    kw = dict(grid_dt=1.0 / 6.0, restart_overhead=RO, device="cpu")
    one = TC.solve(tdists[0], 24, **kw)
    bat = TC.solve_batch(tdists[:1], 24, **kw)
    assert torch.equal(one.V, bat.V[0]) and torch.equal(one.K, bat.K[0])
    assert one.expected_makespan(24) == bat.expected_makespan(0, 24)
    # dollars: solve takes row 0 of a multi-row price grid
    row0 = M.PriceGrid.from_prices(np.asarray(price.prices)[:1], price.dt)
    one = TC.solve(tdists[1], 24, objective="dollars", price=price, **kw)
    bat = TC.solve_batch(tdists[1:2], 24, objective="dollars", price=row0,
                         **kw)
    assert one.objective == "dollars"
    assert torch.equal(one.V, bat.V[0]) and torch.equal(one.K, bat.K[0])


def test_extract_schedule_matches_jax(dists):
    with jax.enable_x64(True):
        ref = C.solve(dists[0], 60, grid_dt=1.0 / 12.0)
        want = C.extract_schedule(ref, 60)
    tab = carry.batch_tables_from_numpy(
        ref.V[None], ref.K[None], grid_dt=1.0 / 12.0, delta_steps=1,
        restart_overhead=0.0, horizon_idx=ref.horizon_idx,
        device="cpu").tables(0)
    assert TC.extract_schedule(tab, 60) == want
    assert sum(want) == 60


def test_validate_rejects_bad_tables(tdists):
    good = TC.solve_batch(tdists, 12, grid_dt=0.5, device="cpu")
    assert good.validate() is good

    def bad(**kw):
        return dataclasses.replace(good, **kw).validate

    V = good.V.clone()
    V[0, 3, 4] = float("inf")
    with pytest.raises(ValueError, match="non-finite"):
        bad(V=V)()
    V = good.V.clone()
    V[1, 2, 2] = -1.0
    with pytest.raises(ValueError, match="negative makespans"):
        bad(V=V)()
    with pytest.raises(ValueError, match="negative dollars"):
        bad(V=V, objective="dollars")()
    K = good.K.clone()
    K[0, 2, 0] = 3
    with pytest.raises(ValueError, match="outside"):
        bad(K=K)()
    K = good.K.clone()
    K[2, 5, 7] = 0
    with pytest.raises(ValueError, match="K < 1"):
        bad(K=K)()


def test_objective_validation_errors(tdists, price):
    kw = dict(grid_dt=0.5, device="cpu")
    with pytest.raises(ValueError, match="expected one of"):
        TC.solve_batch(tdists, 12, objective="euros", **kw)
    with pytest.raises(ValueError, match="requires price"):
        TC.solve_batch(tdists, 12, objective="dollars", **kw)
    with pytest.raises(ValueError, match="only meaningful"):
        TC.solve_batch(tdists, 12, price=price, **kw)
    two = M.PriceGrid.from_prices(np.asarray(price.prices)[:2], price.dt)
    with pytest.raises(ValueError, match="rows"):
        TC.solve_batch(tdists, 12, objective="dollars", price=two, **kw)
    with pytest.raises(ValueError, match="shared deadline"):
        TC.solve_batch([tdists[0], dataclasses.replace(tdists[1], L=12.0)],
                       12, **kw)


def test_backend_resolution():
    assert TSB.resolve("auto", "cpu") == "reference"
    assert TSB.resolve("auto", torch.device("cuda")) == "cuda"
    assert TSB.resolve("reference", "cuda") == "reference"
    assert TSB.resolve("cuda", "cpu") == "cuda"        # explicit name wins
    with pytest.raises(ValueError, match="unknown solver backend"):
        TSB.resolve("pallas", "cpu")


def _dp_inputs(tdists, job, grid_dt):
    grids = [TSB.grids.cdf_grids(d, grid_dt, "cpu") for d in tdists]
    Fc = torch.stack([g[0] for g in grids])
    Hc = torch.stack([g[1] for g in grids])
    return dict(Fc=Fc, Hc=Hc, col0=TSB.grids.seed_column(Fc, job, grid_dt),
                grid_dt=grid_dt, restart_overhead=RO, j_max=job,
                t_max=grids[0][2], delta_steps=1, n_sweeps=2)


def test_wrapper_takes_plain_version_for_cpu_tensors(tdists):
    """A CPU tensor goes to the plain version: same tables, no launch."""
    kw = _dp_inputs(tdists, 24, 1.0 / 6.0)
    before = dp_recurrence.launches
    V, K = dp_recurrence(**kw)
    Vp, Kp = dp_recurrence_plain(**kw)
    assert dp_recurrence.launches == before
    assert torch.equal(V, Vp) and torch.equal(K, Kp)
    assert V.dtype == torch.float32 and K.dtype == torch.int32
    assert tuple(V.shape) == (3, 25, kw["t_max"] + 1)


def test_wrapper_checks_its_inputs(tdists):
    kw = _dp_inputs(tdists, 12, 0.5)
    cases = [
        (dict(Fc=kw["Fc"].double()), "float32"),
        (dict(Hc=kw["Hc"][:, :-1]), "shape"),
        (dict(col0=kw["col0"].t().contiguous().t()), "contiguous"),
        (dict(Pc=torch.zeros(3, kw["t_max"] + 14)), "both Pc and Ro"),
        (dict(Pc=torch.zeros(3, 5), Ro=torch.zeros(3)), "shape"),
        (dict(n_sweeps=0), "n_sweeps >= 1"),
    ]
    for change, match in cases:
        with pytest.raises(ValueError, match=match):
            dp_recurrence(**{**kw, **change})
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v)
            for k, v in kw.items()}
    with pytest.raises(ValueError, match="not meta"):
        dp_recurrence(**meta)


def test_plain_recurrence_breaks_exact_ties_to_the_first_candidate():
    """With F = H = 0 no VM fails, and at grid_dt = 0.25 with no checkpoint
    delay every candidate of row j costs exactly j * 0.25 (sums of
    multiples of 0.25 round to nothing), so the first-match argmin picks
    i = 1 everywhere.  chip_smoke.py holds the kernel to these tables."""
    S, j_max, t_max, dt = 3, 40, 96, 0.25
    Fc = torch.zeros((S, t_max + 1), dtype=torch.float32)
    Hc = torch.zeros_like(Fc)
    col0 = TSB.grids.seed_column(Fc, j_max, dt)
    V, K = dp_recurrence_plain(Fc, Hc, col0, grid_dt=dt, restart_overhead=RO,
                               j_max=j_max, t_max=t_max, delta_steps=0,
                               n_sweeps=2)
    want = (torch.arange(j_max + 1, dtype=torch.float32) * dt)[None, :, None]
    assert torch.equal(V, want.expand(S, j_max + 1, t_max + 1))
    assert bool((K[:, 1:] == 1).all()) and bool((K[:, 0] == 0).all())


# ---- the CUDA kernel's wavefront schedule, replayed on the CPU ------------
#
# dp_recurrence.cu runs a solve as one persistent launch whose blocks claim
# work items (sweep k, row j, scenario s, 32-age tile) from an atomic
# ticket and order the rows with per-(s, row, tile) flags.  A missing wait
# there can pass a run on the card by timing alone, so the emulator below
# replays the kernel's ticket order and wait rules with a few blocks under
# adversarial interleavings and checks, at the start and at the end of each
# read window, that every read of the value table or of the restart-column
# snapshot sees the value its sweep needs: version k + 1 of row j - i (0 for
# row 0, which nothing writes) and snapshot version k (col0 is version 0).
# Versions only grow, so a value seen at both ends of a window was there
# throughout.  Any change to the kernel's waits, ticket order or
# snapshot buffers must be made here too; kTile, kGroups and kLag are read
# from the source.

_DP_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "kernels" / "csrc" / "dp_recurrence.cu")


def _kernel_constants():
    """The ``constexpr int`` constants of dp_recurrence.cu, evaluated in
    order (each is an integer expression of the ones before it)."""
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 _DP_CU.read_text()):
        env[name] = int(eval(expr, {"__builtins__": {}}, dict(env)))
    return env


def _warp_candidates(j, lag, groups):
    """The candidates each warp g scans, as the kernel's two loops do:
    early ones i = g+lag, g+lag+groups, ... <= j; late ones i = g+lag-groups
    and down by groups while > 0 (and <= j)."""
    early, late = [], []
    for g in range(groups):
        early += range(g + lag, j + 1, groups)
        late += [i for i in range(g + lag - groups, 0, -groups) if i <= j]
    return early, late


def _emulate_wavefront(*, S, j_max, t_max, delta, n_sweeps, blocks, policy,
                       seed, mutation=None):
    c = _kernel_constants()
    tile_w, groups, lag = c["kTile"], c["kGroups"], c["kLag"]
    T, J1 = t_max + 1, j_max + 1
    tiles = (T + tile_w - 1) // tile_w
    per_row = S * tiles
    total = n_sweeps * j_max * per_row
    ver = np.zeros((S, J1, T), dtype=np.int64)   # sweep + 1 of the last write
    snap = np.full((2, S, J1), -1, dtype=np.int64)
    snap[0] = 0                                  # col0
    flags = np.zeros((S, J1, tiles), dtype=np.int64)
    ticket = [0]
    rng = random.Random(seed)
    reads = {}

    def read_set(j, tile):
        """(rows, ages) of the early and the late candidates' reads."""
        if (j, tile) not in reads:
            early, late = _warp_candidates(j, lag, groups)
            assert sorted(early + late) == list(range(1, j + 1)), (
                f"row {j}: the warps scan {sorted(early + late)}")
            t = np.arange(tile * tile_w, min((tile + 1) * tile_w, T))
            sets = []
            for cand in (early, late):
                i = np.asarray(cand, dtype=np.int64)
                w = np.where(i == j, i, i + delta)
                e = np.minimum(t[:, None] + w[None, :], t_max)
                sets.append((np.broadcast_to(j - i, e.shape).ravel(),
                             e.ravel()))
            reads[(j, tile)] = sets
        return reads[(j, tile)]

    def check_reads(rows_ages, s, k, what):
        rows, ages = rows_ages
        got = ver[s, rows, ages]
        want = np.where(rows >= 1, k + 1, 0)
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (
            f"sweep {k} scenario {s}: {what} read row {rows[bad[0]]} age "
            f"{ages[bad[0]]} at version {got[bad[0]]}, needs {want[bad[0]]}")

    def row_ready(s, r, k, tile, reach):
        last = min(tile * tile_w + tile_w - 1 + reach, t_max) // tile_w
        return bool((flags[s, r, tile:last + 1] >= k + 1).all())

    def early_ready(k, j, s, tile):
        if mutation == "no early wait":
            return True
        if j - lag >= 1:
            r = j - lag - 1 if mutation == "early wait too old" else j - lag
            reach = lag + delta - (mutation == "early wait one age short")
            return r < 1 or row_ready(s, r, k, tile, reach)
        if k > 0 and mutation != "no sweep barrier":
            return bool((flags[s, j_max] >= k).all())
        return True

    def late_ready(k, j, s, tile):
        reach = {"short late wait": 0, "late wait one age short": delta}.get(
            mutation, 1 + delta)
        return j < 2 or row_ready(s, j - 1, k, tile, reach)

    def block():
        """One persistent block: yields (guard, tag) before each step the
        adversary may delay; a guard is a wait that must hold first."""
        while True:
            yield None, "claim"
            n = ticket[0]
            ticket[0] += 1
            if n >= total:
                return
            r, within = divmod(n, per_row)
            k, j = r // j_max, r % j_max + 1
            tile, s = tiles - 1 - within // S, within % S
            early, late = read_set(j, tile)
            buf = 0 if mutation == "one snapshot buffer" else k & 1
            yield (lambda: early_ready(k, j, s, tile)), "open"
            for _ in range(2):          # the early window's two ends
                assert snap[buf, s, j] == k, (
                    f"sweep {k} scenario {s} row {j}: restart column at "
                    f"version {snap[buf, s, j]}, needs {k}")
                check_reads(early, s, k, "an early candidate")
                yield None, "close"
            yield (lambda: late_ready(k, j, s, tile)), "open"
            for _ in range(2):          # the late window's two ends
                check_reads(late, s, k, "a late candidate")
                yield None, "close"
            ver[s, j, tile * tile_w:(tile + 1) * tile_w] = k + 1
            if tile == 0:
                nbuf = 0 if mutation == "one snapshot buffer" else (k + 1) & 1
                snap[nbuf, s, j] = k + 1
            yield None, "release"
            flags[s, j, tile] = k + 1

    state = []             # [generator, guard, tag, ticket held, slow]
    for _ in range(blocks):
        gen = block()
        guard, tag = next(gen)
        state.append([gen, guard, tag, -1, False])
    while state:
        ready = [b for b in state if b[1] is None or b[1]()]
        assert ready, f"deadlock: {len(state)} blocks wait, none can run"
        if policy == "random":
            pick = rng.choice(ready)
        elif policy == "newest":   # later items run as far ahead as allowed
            pick = max(ready, key=lambda b: (b[2] == "claim", b[3]))
        elif policy == "stall":    # read windows stay open longest
            keep_open = [b for b in ready if b[2] != "close"]
            pick = rng.choice(keep_open or ready)
        else:                      # "starve": a third of the items crawl
            fast = [b for b in ready if not b[4]]
            pick = rng.choice(fast if fast and rng.random() > 0.01 else ready)
        if pick[2] == "claim":
            pick[3] = ticket[0]
            pick[4] = rng.random() < 1 / 3
        try:
            pick[1], pick[2] = next(pick[0])
        except StopIteration:
            state.remove(pick)
    assert ticket[0] >= total
    assert (ver[:, 1:] == n_sweeps).all() and (ver[:, 0] == 0).all()
    assert (flags[:, 1:] == n_sweeps).all()


_SCHEDULE = dict(S=2, j_max=21, t_max=100, n_sweeps=3)


# Blocks up to 96 let ~10 rows of 8 items be in flight at once, as many
# resident blocks do on the card for a solve of few scenarios.  A delta of
# 0 or 24 puts the late or the early wait's last age on a tile's first age,
# where a wait one age short misses a tile.
@pytest.mark.parametrize("policy,blocks,delta,seed", [
    ("random", 3, 0, 0), ("random", 96, 1, 1), ("newest", 96, 24, 0),
    ("newest", 1, 1, 0), ("stall", 9, 2, 2), ("stall", 96, 0, 3),
    ("starve", 96, 24, 4), ("starve", 16, 1, 5)])
def test_wavefront_schedule_reads_only_final_values(policy, blocks, delta,
                                                     seed):
    """Under every interleaving tried, each read of the kernel's wavefront
    sees the final value of its own sweep, no block deadlocks, and every
    row ends at the last sweep."""
    _emulate_wavefront(**_SCHEDULE, delta=delta, blocks=blocks,
                       policy=policy, seed=seed)


@pytest.mark.parametrize("mutation,delta", [
    ("no early wait", 1), ("early wait too old", 1),
    ("early wait one age short", 24), ("short late wait", 1),
    ("late wait one age short", 0), ("no sweep barrier", 1),
    ("one snapshot buffer", 1)])
def test_wavefront_emulator_catches_a_broken_wait(mutation, delta):
    """Each of these broken variants of the schedule lets some read see a
    value of the wrong sweep under one of the interleavings tried, so the
    emulator can tell a sound schedule from a broken one."""
    caught = []
    for policy, blocks, seed in [("newest", 96, 0), ("starve", 96, 1),
                                 ("stall", 96, 4), ("random", 5, 3)]:
        try:
            _emulate_wavefront(**_SCHEDULE, delta=delta, blocks=blocks,
                               policy=policy, seed=seed, mutation=mutation)
        except AssertionError as err:
            caught.append(str(err))
    assert caught, f"no interleaving exposed the mutation {mutation!r}"
