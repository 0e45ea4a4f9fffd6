"""Parity of the PyTorch port's market layer with ``repro.core.market`` and
``repro``'s market sweep (JAX under x64), on the CPU, at a small size.

Contracts, each with its tolerance:
- Price traces, ``PriceGrid`` (prices, cum, shift, price_at),
  ``MarketModel.grid``, ``PriceFeed`` and the crunch-coupled Eq. 1 fields:
  bit-identical (host numpy float64 on both sides).
- ``engine.accumulate_price_cost``: bit-identical to the serial
  ``integrate_cost_ref`` (port and ``repro``) and to ``repro``'s gather,
  at cell edges, one ulp either side, past the horizon and at NaN.
- ``evaluate_policy_dollars``: rtol 1e-12 (float64 recurrences whose
  lifetime grids differ in the last bits of exp).
- ``solve_market_tables``: the DP contract, V within rtol = atol = 1e-5,
  K agreement >= 0.999 (makespan) or >= 0.995 (dollars).
- ``sweep_market``: every row bit-identical when both sides run on the same
  pools and ``repro``'s tables; rtol 1e-9 on the port's own pools (pools
  agree to ~1e-15); on each side's own solve, the same ``chosen`` leaf in
  every row and dollars within rtol 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import distributions as D
from repro.core import engine as E
from repro.core import market as M
from repro.core import scenarios as SC
from repro.core.policies import checkpointing as C
from repro_torch.core import carry
from repro_torch.core import distributions as TD
from repro_torch.core import engine as TE
from repro_torch.core import market as TM
from repro_torch.core import scenarios as TSC
from repro_torch.core.policies import checkpointing as TC

KW = dict(job_steps=20, grid_dt=1.0 / 6.0)
SWEEP = dict(KW, n_trials=50, seeds=(0, 1))
PROCS = [
    dict(),
    dict(crunch_t0=2.0, crunch_t1=5.0, crunch_period=12.0),
    dict(crunch_t0=8.0, crunch_t1=16.0, theta=0.0, sigma=0.2),
]


@pytest.fixture(scope="module")
def jax_market():
    with jax.enable_x64(True):
        scs = SC.default_grid()
        mkt = M.MarketModel.for_scenarios(scs)
        mkt.grid()
        tabs = {obj: SC.solve_market_tables(scs, mkt, dp_objective=obj, **KW)
                for obj in ("makespan", "dollars")}
    return scs, mkt, tabs


def _port_market():
    scs = TSC.default_grid()
    return scs, TM.MarketModel.for_scenarios(scs)


def _carried(tabs):
    return {r: carry.batch_tables_from_numpy(
        b.V, b.K, grid_dt=b.grid_dt, delta_steps=b.delta_steps,
        restart_overhead=b.restart_overhead, horizon_idx=b.horizon_idx,
        objective=b.objective, device="cpu") for r, b in tabs.items()}


def _same(a, b):
    return a == b or (a != a and b != b)


# ---------------------------------------------------------------------------
# prices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", PROCS, ids=["calm", "periodic", "theta0"])
def test_price_trace_and_grid_bit_identical(over):
    jp = M.spot_price_process("us-central1-a", "n1-highcpu-32", **over)
    tp = TM.spot_price_process("us-central1-a", "n1-highcpu-32", **over)
    for f in dataclasses.fields(jp):
        assert float(getattr(tp, f.name)) == float(getattr(jp, f.name))
    rows_j = [M.price_trace(jp, horizon=24.0, dt=0.1, seed=s, leaf=lf)
              for s, lf in ((0, 0), (3, 2))]
    rows_t = [TM.price_trace(tp, horizon=24.0, dt=0.1, seed=s, leaf=lf)
              for s, lf in ((0, 0), (3, 2))]
    for a, b in zip(rows_t, rows_j):
        assert np.array_equal(a, b)
    hours = np.linspace(0.0, 30.0, 61)
    assert np.array_equal(TM.crunch_profile(tp, hours),
                          M.crunch_profile(jp, hours))
    gj, gt = M.PriceGrid.from_prices(rows_j, 0.1), \
        TM.PriceGrid.from_prices(rows_t, 0.1)
    assert np.array_equal(gt.prices, gj.prices)
    assert np.array_equal(gt.cum, gj.cum)
    assert gt.horizon == gj.horizon and len(gt) == len(gj) == 2
    for t0 in (0.0, 0.05, 8.0, 23.95, 100.0):
        sj, st = gj.shift(t0), gt.shift(t0)
        assert np.array_equal(st.prices, sj.prices)
        assert np.array_equal(st.cum, sj.cum)
        assert np.array_equal(gt.price_at(t0), gj.price_at(t0))


def test_price_grid_and_trace_errors():
    with pytest.raises(ValueError, match="strictly positive"):
        TM.PriceGrid.from_prices([[0.1, 0.0]], 0.5)
    with pytest.raises(ValueError, match="empty grid"):
        TM.price_trace(TM.PriceProcess(), horizon=0.01, dt=0.1)
    with pytest.raises(ValueError, match="p0 must be positive"):
        TM.price_trace(TM.PriceProcess(p0=0.0))


def test_market_model_bit_identical(jax_market):
    scs, mkt, _ = jax_market
    tscs, tm = _port_market()
    assert np.array_equal(tm.grid().prices, mkt.grid().prices)
    assert np.array_equal(tm.grid().cum, mkt.grid().cum)
    for regime in ("calm", "crunch"):
        t0 = mkt.launch_time(regime)
        assert tm.launch_time(regime) == t0
        with jax.enable_x64(True):
            want = mkt.crunch_dists(scs, t0)
        for w, g in zip(want, tm.crunch_dists(tscs, t0)):
            assert type(g).__name__ == type(w).__name__ == "Constrained"
            for f in dataclasses.fields(w):
                assert float(getattr(g, f.name)) == float(getattr(w, f.name))
    with pytest.raises(ValueError, match="regime"):
        tm.launch_time("storm")
    calm_only = TM.MarketModel([TM.spot_price_process()])
    assert calm_only.launch_time("crunch") == 0.0


def test_crunch_effective_matches_jax():
    """crunch_effective on a base and a diurnal model, inside and outside
    a (periodic) crunch window, field by field."""
    proc = dict(crunch_t0=2.0, crunch_t1=5.0, crunch_period=12.0,
                crunch_A=2.5, crunch_tau1=0.3)
    jp, tp = M.PriceProcess(**proc), TM.PriceProcess(**proc)
    for jd, td in ((D.constrained_for("n1-highcpu-32"),
                    TD.constrained_for("n1-highcpu-32")),
                   (D.diurnal_for("n1-highcpu-16", 20.0),
                    TD.diurnal_for("n1-highcpu-16", 20.0))):
        for t in (0.0, 3.0, 14.5, 30.0):
            with jax.enable_x64(True):
                want = M.crunch_effective(jd, jp, t)
            got = TM.crunch_effective(td, tp, t)
            for f in dataclasses.fields(want):
                assert float(getattr(got, f.name)) == \
                    float(getattr(want, f.name)), (t, f.name)


def test_price_process_stacks_on_the_scenario_axis():
    procs = [TM.spot_price_process(z, v, crunch_t0=c, crunch_t1=c + 4.0)
             for z, v, c in (("us-east1-b", "n1-highcpu-16", 1.0),
                             ("europe-west1-d", "n1-highcpu-32", 6.0))]
    st = TD.stack(procs)
    assert st.mu.shape == (2,) and st.mu.dtype == torch.float64
    back = TD.unstack(st)
    for a, b in zip(back, procs):
        assert float(a.p0) == float(b.p0)
        assert np.array_equal(a.crunch_intensity([0.5, 2.0, 7.0]),
                              b.crunch_intensity([0.5, 2.0, 7.0]))


def test_price_feed_bit_identical():
    jf = M.PriceFeed(M.spot_price_process(crunch_t0=1.0, crunch_t1=2.0),
                     seed=4, block=16)
    tf = TM.PriceFeed(TM.spot_price_process(crunch_t0=1.0, crunch_t1=2.0),
                      seed=4, block=16)
    for _ in range(70):
        assert tf.advance() == jf.advance()
    assert tf.clock_hours == jf.clock_hours
    gj, gt = jf.grid(5.0), tf.grid(5.0)
    assert np.array_equal(gt.prices, gj.prices)
    assert np.array_equal(gt.cum, gj.cum)
    assert tf.price_at(40.0) == jf.price_at(40.0)


# ---------------------------------------------------------------------------
# the dollar gather
# ---------------------------------------------------------------------------

def _makespans(grid):
    """(3, 40) makespans: cell edges, one ulp either side of one, zero,
    past the horizon, NaN and seeded draws inside the grid."""
    dt, H = grid.dt, grid.horizon
    edges = np.arange(1, 9) * dt
    special = np.concatenate([
        edges, np.nextafter(edges, 0.0), np.nextafter(edges, np.inf),
        [0.0, H, np.nextafter(H, 0.0), H + 3.7, 10.0 * H, np.nan]])
    rng = np.random.default_rng(5)
    rest = rng.uniform(0.0, 0.9 * H, (3, 40 - special.size))
    return np.concatenate([np.broadcast_to(special, (3, special.size)),
                           rest], axis=1)


def test_accumulate_price_cost_bit_identical(jax_market):
    _, mkt, _ = jax_market
    g = mkt.grid().shift(8.0)
    tg = TM.MarketModel.for_scenarios(TSC.default_grid()).grid().shift(8.0)
    m = _makespans(g)
    for pidx in (None, [0, 3, 7], [5, 5, 5]):
        got = TE.accumulate_price_cost(tg, m, pidx, device="cpu")
        with jax.enable_x64(True):
            want = E.accumulate_price_cost(g, m, pidx)
        rows = np.arange(3) if pidx is None else np.asarray(pidx)
        ref_t = np.array([[TM.integrate_cost_ref(tg.prices[s], tg.cum[s],
                                                 tg.dt, x) for x in m[b]]
                          for b, s in enumerate(rows)])
        ref_j = np.array([[M.integrate_cost_ref(g.prices[s], g.cum[s],
                                                g.dt, x) for x in m[b]]
                          for b, s in enumerate(rows)])
        for other in (np.asarray(want), ref_t, ref_j):
            assert np.array_equal(got, other, equal_nan=True)
    assert np.isnan(got[:, 29]).all() and not np.isnan(got[:, :29]).any()
    one = TE.accumulate_price_cost(tg, m[1], [4], device="cpu")
    assert one.shape == (40,)
    with jax.enable_x64(True):
        assert np.array_equal(one, E.accumulate_price_cost(g, m[1], [4]),
                              equal_nan=True)
    with pytest.raises(ValueError, match="price_index out of range"):
        TE.accumulate_price_cost(tg, m, [0, 1, 8], device="cpu")


# ---------------------------------------------------------------------------
# dollar evaluation and tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta,ro", [(1, 0.0), (2, 0.3)])
@pytest.mark.parametrize("regime", ["calm", "crunch"])
def test_evaluate_policy_dollars_matches_jax(jax_market, regime, delta, ro):
    scs, mkt, tabs = jax_market
    tscs, tm = _port_market()
    t0 = mkt.launch_time(regime)
    K = np.asarray(tabs["makespan"][regime].K)
    kw = dict(grid_dt=KW["grid_dt"], delta_steps=delta, restart_overhead=ro)
    with jax.enable_x64(True):
        want = C.evaluate_policy_dollars(K, mkt.crunch_dists(scs, t0),
                                         mkt.grid().shift(t0), **kw)
    got = TC.evaluate_policy_dollars(torch.from_numpy(K.copy()),
                                     tm.crunch_dists(tscs, t0),
                                     tm.grid().shift(t0), device="cpu", **kw)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    # one price row broadcasts over the scenarios
    row = TM.PriceGrid.from_prices(tm.grid().prices[:1], tm.dt)
    with jax.enable_x64(True):
        want1 = C.evaluate_policy_dollars(
            K, mkt.crunch_dists(scs, t0),
            M.PriceGrid.from_prices(mkt.grid().prices[:1], mkt.dt), **kw)
    got1 = TC.evaluate_policy_dollars(K, tm.crunch_dists(tscs, t0), row,
                                      device="cpu", **kw)
    np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-12, atol=0)


@pytest.mark.parametrize("objective,k_min", [("makespan", 0.999),
                                             ("dollars", 0.995)])
def test_solve_market_tables_matches_jax(jax_market, objective, k_min):
    _, _, tabs = jax_market
    tscs, tm = _port_market()
    got = TSC.solve_market_tables(tscs, tm, dp_objective=objective,
                                  device="cpu", **KW)
    assert set(got) == {"calm", "crunch"}
    for regime, want in tabs[objective].items():
        g = got[regime].validate()
        assert g.objective == objective
        np.testing.assert_allclose(g.V.numpy(), np.asarray(want.V),
                                   rtol=1e-5, atol=1e-5)
        assert (g.K.numpy() == np.asarray(want.K)).mean() >= k_min


# ---------------------------------------------------------------------------
# the market sweep
# ---------------------------------------------------------------------------

@pytest.fixture
def shared_pools(monkeypatch):
    """The port's sweep draws ``repro``'s pools (float64, under x64) for the
    same crunch-coupled models and seed, so both sides execute one pool."""
    def draw(dists, n_trials, *, max_restarts=64, seed=0, device="cuda"):
        jd = [D.Constrained(**{f.name: float(getattr(d, f.name))
                               for f in dataclasses.fields(d)})
              for d in dists]
        with jax.enable_x64(True):
            first, pool = E.draw_lifetime_pool_batch(
                jd, n_trials, max_restarts=max_restarts, seed=seed)
        return (torch.as_tensor(np.array(first), device=device),
                torch.as_tensor(np.array(pool), device=device))
    monkeypatch.setattr(TE, "draw_lifetime_pool_batch", draw)


@pytest.mark.parametrize("objective", ["makespan", "dollars"])
@pytest.mark.parametrize("cost_path", ["kernel", "reference"])
def test_sweep_market_rows_bit_identical_on_shared_pools_and_tables(
        jax_market, shared_pools, cost_path, objective):
    scs, mkt, tabs = jax_market
    with jax.enable_x64(True):
        want = SC.sweep_market(scs, market=mkt, tables=tabs[objective],
                               cost_path=cost_path, dp_objective=objective,
                               **SWEEP)
    tscs, tm = _port_market()
    got = TSC.sweep_market(tscs, market=tm, tables=_carried(tabs[objective]),
                           cost_path=cost_path, dp_objective=objective,
                           device="cpu", **SWEEP)
    assert len(got) == len(want) == 8 * 2 * 3 * 2
    assert {r["policy"] for r in got} == {"fixed", "cheapest", "migrate"}
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert _same(g[k], w[k]), (k, g[k], w[k])


def test_sweep_market_own_pools_and_own_solve(jax_market):
    scs, mkt, tabs = jax_market
    with jax.enable_x64(True):
        want = SC.sweep_market(scs, market=mkt, **SWEEP)
    tscs, tm = _port_market()
    carried = TSC.sweep_market(tscs, market=tm,
                               tables=_carried(tabs["makespan"]),
                               device="cpu", **SWEEP)
    own = TSC.sweep_market(tscs, market=tm, device="cpu", **SWEEP)
    for c, o, w in zip(carried, own, want):
        assert c["chosen"] == o["chosen"] == w["chosen"]
        assert c["unfinished_frac"] == w["unfinished_frac"] == 0.0
        for k in ("expected_dollars", "dollars_p50", "makespan_mean"):
            np.testing.assert_allclose(c[k], w[k], rtol=1e-9, atol=0)
            np.testing.assert_allclose(o[k], w[k], rtol=1e-6, atol=0)


def test_sweep_market_kernel_and_reference_paths_agree():
    tscs, tm = _port_market()
    kw = dict(SWEEP, seeds=(3,), regimes=("crunch",), device="cpu")
    a = TSC.sweep_market(tscs, market=tm, **kw)
    b = TSC.sweep_market(tscs, market=tm, cost_path="reference", **kw)
    assert all(_same(x["expected_dollars"], y["expected_dollars"])
               and _same(x["dollars_p50"], y["dollars_p50"])
               for x, y in zip(a, b))


def test_sweep_market_errors(jax_market):
    _, _, tabs = jax_market
    tscs, tm = _port_market()
    kw = dict(SWEEP, market=tm, device="cpu")
    carried = _carried(tabs["makespan"])
    with pytest.raises(ValueError, match="no entry for regime"):
        TSC.sweep_market(tscs, tables={"calm": carried["calm"]}, **kw)
    with pytest.raises(ValueError, match="this sweep needs"):
        TSC.sweep_market(tscs, tables=carried, **dict(kw, job_steps=21))
    with pytest.raises(ValueError, match="different"):
        TSC.sweep_market(tscs, tables=carried, **dict(kw, delta_steps=2))
    with pytest.raises(ValueError, match="objective='makespan'"):
        TSC.sweep_market(tscs, tables=carried, dp_objective="dollars", **kw)
    with pytest.raises(ValueError, match="cost_path"):
        TSC.sweep_market(tscs, cost_path="fast", **kw)
    with pytest.raises(ValueError, match="unknown market policies"):
        TSC.sweep_market(tscs, policies=("fixed", "spot"), **kw)
    with pytest.raises(ValueError, match="leaves for"):
        TSC.sweep_market(tscs[:3], **kw)


def test_market_bench_acceptance_flags_at_reduced_size():
    """``benchmarks/market_bench.py``'s two acceptance flags on the port at
    J = 60, dt = 1/12, 60 trials, seed 0: ``cheapest`` pays less than
    ``fixed`` on every crunch-scheduled leaf, and on every crunch leaf the
    dollar DP's K costs at most the makespan DP's x (1 + 1e-6) under
    ``evaluate_policy_dollars``."""
    tscs, tm = _port_market()
    kw = dict(job_steps=60, grid_dt=1.0 / 12.0)
    tabs = TSC.solve_market_tables(tscs, tm, device="cpu", **kw)
    tabs_d = TSC.solve_market_tables(tscs, tm, dp_objective="dollars",
                                     device="cpu", **kw)
    rows = TSC.sweep_market(tscs, market=tm, tables=tabs, n_trials=60,
                            seeds=(0,), device="cpu", **kw)
    fixed = {r["scenario"]: r["expected_dollars"] for r in rows
             if r["regime"] == "crunch" and r["policy"] == "fixed"
             and r["crunch"]}
    cheap = {r["scenario"]: r["expected_dollars"] for r in rows
             if r["regime"] == "crunch" and r["policy"] == "cheapest"
             and r["crunch"]}
    assert len(fixed) == 4 and all(cheap[k] < fixed[k] for k in fixed)
    t0 = tm.launch_time("crunch")
    dl, g = tm.crunch_dists(tscs, t0), tm.grid().shift(t0)
    ev_mk = TC.evaluate_policy_dollars(tabs["crunch"].K, dl, g,
                                       grid_dt=kw["grid_dt"], device="cpu")
    ev_d = TC.evaluate_policy_dollars(tabs_d["crunch"].K, dl, g,
                                      grid_dt=kw["grid_dt"], device="cpu")
    on = [s for s, p in enumerate(tm.processes) if p.crunched]
    assert len(on) == 4
    for s in on:
        assert float(ev_d[s, 60, 0]) <= float(ev_mk[s, 60, 0]) * (1 + 1e-6)
