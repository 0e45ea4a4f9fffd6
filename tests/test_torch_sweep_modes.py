"""The PyTorch port's sweep modes and the Fig. 7 evaluation path against
``repro`` (JAX under x64), on the CPU at a small size.

Contracts:
- the port's three ``sweep_checkpointing`` modes give identical rows in
  every field, and the serial mode's per-scenario solve equals the batched
  solve's scenario bit for bit;
- with ``repro``'s tables carried across, the grouped rows match
  ``repro``'s grouped rows at rtol 1e-9 (pools agree to ~1e-15, the
  executor is bit-identical on a shared pool); with the port's own DP the
  serial mode's DP scalars match ``repro``'s serial mode at rtol 1e-5;
- ``checkpointing.simulate_makespan`` (the host reference loop) is
  bit-identical to ``repro``'s on one shared pool, and the port's
  ``engine.simulate_makespan_engine`` bit-identical to it on the same seed
  (float64);
- ``engine.draw_lifetime_pool`` through ``model_lifetimes_fn`` matches
  ``repro``'s at rtol 1e-10 and its pool block equals the batched pool's
  row bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import distributions as D
from repro.core import engine as E
from repro.core import scenarios as SC
from repro.core.policies import checkpointing as C
from repro.core.policies import young_daly as YD
from repro_torch.core import carry
from repro_torch.core import distributions as TD
from repro_torch.core import engine as TE
from repro_torch.core import scenarios as TSC
from repro_torch.core.policies import checkpointing as TC
from repro_torch.core.policies import young_daly as TYD

JOB, GRID = 60, 1.0 / 12.0
KW = dict(seeds=(0, 1), job_steps=JOB, n_trials=300, grid_dt=GRID)
MODES = ("serial", "grouped", "batched")


def _port(family, d):
    fields = {f.name: np.asarray(getattr(d, f.name))
              for f in dataclasses.fields(d)}
    return carry.dist_from_numpy(family, fields, device="cpu")


def _same_rows(a, b):
    """Every field equal, NaN equal to NaN."""
    assert len(a) == len(b) == 48
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k] == y[k] or (x[k] != x[k] and y[k] != y[k]), k


def _assert_rows_close(got, want, rtol, keys=None):
    assert len(got) == len(want) == 48
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in keys or w:
            if isinstance(w[k], float):
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=0,
                                           err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def port_rows():
    grid = TSC.default_grid()
    return {m: TSC.sweep_checkpointing(grid, mode=m, device="cpu", **KW)
            for m in MODES}


@pytest.fixture(scope="module")
def jax_side():
    """``repro``'s tables and its grouped and serial rows."""
    with jax.enable_x64(True):
        grid = SC.default_grid()
        tables = C.solve_batch([sc.dist() for sc in grid], JOB, grid_dt=GRID)
        grouped = SC.sweep_checkpointing(grid, mode="grouped", tables=tables,
                                         **KW)
        serial = SC.sweep_checkpointing(grid, mode="serial", **KW)
    return tables, grouped, serial


def _carried(tables):
    return carry.batch_tables_from_numpy(
        tables.V, tables.K, grid_dt=tables.grid_dt,
        delta_steps=tables.delta_steps,
        restart_overhead=tables.restart_overhead,
        horizon_idx=tables.horizon_idx, device="cpu")


# -- (1) the port's modes against each other ---------------------------------

@pytest.mark.parametrize("mode", ["serial", "grouped"])
def test_modes_give_identical_rows(port_rows, mode):
    _same_rows(port_rows[mode], port_rows["batched"])
    assert all(r["unfinished_frac"] == 0.0 for r in port_rows[mode])


def test_serial_tables_equal_solve_batch():
    dists = [sc.dist() for sc in TSC.default_grid()]
    batch = TC.solve_batch(dists, JOB, grid_dt=GRID, device="cpu")
    for s, d in enumerate(dists):
        one = TC.solve(d, JOB, grid_dt=GRID, device="cpu")
        assert torch.equal(one.V, batch.V[s]) and torch.equal(one.K,
                                                              batch.K[s])


# -- (2), (3) the port's modes against repro's -------------------------------

def test_grouped_with_carried_tables_matches_jax(jax_side):
    tables, want, _ = jax_side
    got = TSC.sweep_checkpointing(TSC.default_grid(), mode="grouped",
                                  tables=_carried(tables), device="cpu", **KW)
    _assert_rows_close(got, want, rtol=1e-9)


def test_serial_with_own_dp_matches_jax(jax_side, port_rows):
    _, _, want = jax_side
    got = port_rows["serial"]
    _assert_rows_close(got, want, rtol=1e-5,
                       keys=("scenario", "policy", "seed", "p_fail_fresh",
                             "expected_makespan_dp"))
    for r in got:
        assert np.isfinite(r["makespan_mean"])
        if r["policy"] == "dp":
            assert abs(r["makespan_mean"] - r["expected_makespan_dp"]) \
                < 0.05 * r["expected_makespan_dp"]


# -- (4), (5) the reference loop and the engine ------------------------------

@pytest.fixture(scope="module")
def fig7_case():
    """n1-highcpu-32 (the fastest initial decay): ``repro``'s DP tables for
    delta 1 and 2 and the same model in both packages."""
    d = D.constrained_for("n1-highcpu-32")
    with jax.enable_x64(True):
        tabs = {delta: C.solve(d, JOB, grid_dt=GRID, delta_steps=delta)
                for delta in (1, 2)}
    return d, _port("constrained", d), tabs


def _policies(tabs, delta):
    """(name, repro policy_fn, port policy_fn, port table) per policy."""
    t = tabs[delta]
    carried = carry.tables_from_numpy(
        t.V, t.K, grid_dt=t.grid_dt, delta_steps=t.delta_steps,
        restart_overhead=t.restart_overhead, horizon_idx=t.horizon_idx,
        device="cpu")
    tau = 0.5
    return (("dp", C.dp_policy_fn(t), TC.dp_policy_fn(carried),
             TE.dp_policy_table(carried)),
            ("young_daly", C.young_daly_policy_fn(tau, GRID),
             TC.young_daly_policy_fn(tau, GRID),
             TE.young_daly_policy_table(round(tau / GRID), JOB)),
            ("none", C.no_checkpoint_policy_fn(),
             TC.no_checkpoint_policy_fn(),
             TE.no_checkpoint_policy_table(JOB)))


SIM_CASES = [(age, delta, ro) for age in (0.0, 2.0, 10.0)
             for delta in (1, 2) for ro in (0.0, 2.0 / 60.0)]


@pytest.mark.parametrize("start_age,delta,ro", SIM_CASES)
def test_reference_loop_matches_jax(fig7_case, start_age, delta, ro):
    """One numpy pool from ``repro``'s sampler; max_restarts 1 truncates
    trials, which both loops report with the time they accumulated."""
    d, _, tabs = fig7_case
    with jax.enable_x64(True):
        first, pool = E.draw_lifetime_pool(C.model_lifetimes_fn(d), 300,
                                           max_restarts=1, seed=5,
                                           start_age=start_age)
    kw = dict(grid_dt=GRID, delta_steps=delta, start_age=start_age,
              restart_overhead=ro, max_restarts=1, pool=pool, first=first)
    truncated = 0
    for name, f_jax, f_port, table in _policies(tabs, delta):
        want = C.simulate_makespan(f_jax, None, JOB, **kw)
        got = TC.simulate_makespan(f_port, None, JOB, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        _, fin = TE.simulate_makespan_batch(
            table, JOB, first=first, pool=pool, grid_dt=GRID,
            delta_steps=delta, start_age=start_age, restart_overhead=ro,
            max_restarts=1, unfinished="partial", return_finished=True,
            device="cpu")
        truncated += int((~fin).sum())
    # from 10 h a 5 h job ends in the stable phase: no trial is preempted
    assert truncated > 0 if start_age < 10 else truncated == 0


@pytest.mark.parametrize("start_age,delta,ro",
                         [(0.0, 1, 0.0), (2.0, 2, 2.0 / 60.0),
                          (10.04, 1, 2.0 / 60.0)])
def test_engine_matches_reference_loop(fig7_case, start_age, delta, ro):
    """Same sampler and seed; 10.04 h is off the grid (a sub-step offset);
    max_restarts 3 with ``unfinished="partial"`` keeps truncated trials."""
    _, dist, tabs = fig7_case
    lf = TC.model_lifetimes_fn(dist, device="cpu")
    kw = dict(grid_dt=GRID, delta_steps=delta, start_age=start_age,
              restart_overhead=ro, max_restarts=3, n_trials=200, seed=17)
    for name, _, f_port, table in _policies(tabs, delta):
        want = TC.simulate_makespan(f_port, lf, JOB, **kw)
        got, fin = TE.simulate_makespan_engine(
            table, lf, JOB, unfinished="partial", return_finished=True,
            device="cpu", **kw)
        assert np.array_equal(got, want), name
        if name == "none" and start_age < 10:
            assert not fin.all()


# -- (6) lifetime pools -------------------------------------------------------

@pytest.mark.parametrize("family,vm,clock,start_age", [
    ("constrained", "n1-highcpu-16", None, 0.0),
    ("constrained", "n1-highcpu-16", None, 2.0),
    ("diurnal_constrained", "n1-highcpu-32", 20.0, 0.0),
    ("diurnal_constrained", "n1-highcpu-16", 8.0, 10.0)])
def test_pool_draw_matches_jax(family, vm, clock, start_age):
    d = (D.constrained_for(vm) if clock is None
         else D.diurnal_for(vm, clock))
    with jax.enable_x64(True):
        want_first, want_pool = E.draw_lifetime_pool(
            C.model_lifetimes_fn(d), 300, max_restarts=8, seed=3,
            start_age=start_age)
    port = _port(family, d)
    first, pool = TE.draw_lifetime_pool(
        TC.model_lifetimes_fn(port, device="cpu"), 300, max_restarts=8,
        seed=3, start_age=start_age)
    assert first.dtype == pool.dtype == torch.float64
    np.testing.assert_allclose(first.numpy(), want_first, rtol=1e-10, atol=0)
    np.testing.assert_allclose(pool.numpy(), want_pool, rtol=1e-10, atol=0)
    # the batched draw of the same (model, seed) row, to the bit
    bf, bp = TE.draw_lifetime_pool_batch([port, port], 300, max_restarts=8,
                                         seed=[9, 3], start_age=start_age,
                                         device="cpu")
    assert torch.equal(bf[1], first) and torch.equal(bp[1], pool)


def test_pool_draw_without_min_age_falls_back_to_first_column():
    def sampler(rng, n):
        return rng.exponential(2.0, size=n)
    want_first, want_pool = E.draw_lifetime_pool(sampler, 50, max_restarts=4,
                                                 seed=1, start_age=3.0)
    first, pool = TE.draw_lifetime_pool(sampler, 50, max_restarts=4, seed=1,
                                        start_age=3.0)
    assert np.array_equal(pool.numpy(), want_pool)
    assert np.array_equal(first.numpy(), want_first)
    assert torch.equal(first, pool[:, 0])


# -- (7) Young-Daly and the phases ------------------------------------------

@pytest.mark.parametrize("delta,mttf,ro", [(1 / 60, 1.0, 2 / 60),
                                           (0.05, 3.5, 0.0)])
def test_young_daly_matches_jax(delta, mttf, ro):
    with jax.enable_x64(True):
        want_s = YD.schedule(5.0, delta, mttf)
        want_o = YD.expected_overhead(delta, mttf, ro)
    assert TYD.schedule(5.0, delta, mttf) == want_s
    assert TYD.expected_overhead(delta, mttf, ro) == want_o
    with pytest.raises(ValueError, match="non-positive"):
        TYD.schedule(5.0, 0.0, mttf)


@pytest.mark.parametrize("family,dist", [
    ("constrained", D.constrained_for("n1-highcpu-32")),
    ("constrained", D.Constrained(tau1=2.0, tau2=0.9, b=24.0, A=0.3)),
    ("diurnal_constrained", D.diurnal_for("n1-highcpu-16", 20.0)),
    ("diurnal_constrained", D.diurnal_for("n1-highcpu-2", 8.0))])
def test_phases_match_jax(family, dist):
    with jax.enable_x64(True):
        want = [float(x) for x in dist.phases()]
    got = _port(family, dist).phases()
    assert all(isinstance(x, torch.Tensor) for x in got)
    np.testing.assert_allclose([float(x) for x in got], want, rtol=1e-12)


def test_phases_with_float_fields_match_jax():
    """``constrained_for`` gives Python-float fields (the Fig. 7 model)."""
    with jax.enable_x64(True):
        want = [float(x) for x in D.constrained_for("n1-highcpu-16").phases()]
    got = TD.constrained_for("n1-highcpu-16").phases()
    np.testing.assert_allclose([float(x) for x in got], want, rtol=1e-12)


# -- (8) errors ---------------------------------------------------------------

def test_mode_errors_match_jax(jax_side):
    tables = jax_side[0]
    cases = ((dict(mode="fold"), dict(mode="fold")),
             (dict(mode="serial", tables=tables),
              dict(mode="serial", tables=_carried(tables))))
    for jax_kw, port_kw in cases:
        with jax.enable_x64(True), pytest.raises(ValueError) as want:
            SC.sweep_checkpointing(SC.default_grid(), **KW, **jax_kw)
        with pytest.raises(ValueError) as got:
            TSC.sweep_checkpointing(TSC.default_grid(), device="cpu", **KW,
                                    **port_kw)
        assert str(got.value) == str(want.value)
