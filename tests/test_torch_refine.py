"""Coarse-to-fine DP refinement in the PyTorch port
(``solver_backends/refine.py``, ``solve_batch(refine=True)``), on the CPU.

Contracts:
- ``plan``, ``cone_segments`` and ``candidate_caps`` (host functions)
  equal ``repro``'s on shared inputs.
- A verified refined solve is bit-identical (V and K) to the port's plain
  solve of the same backend: both objectives, cold and warm, delta 1 and
  2; ``refine_check="full"`` confirms it in-process.  Every candidate cost
  comes from the plain version's own expression (``candidate_terms`` /
  ``candidate_cost``) and a capped prefix min equals the full min whenever
  the prefix holds a minimizer.
- A failed column-0 check (caps forced to 1) serves the unrefined tables
  with ``fallback: True``; a grid too small to refine is solved plainly
  with ``{"applied": False, "reason": "degenerate"}``.
- Against ``repro``'s refined tables (JAX under x64): the DP contract, V
  within rtol = atol = 1e-5 and K agreement > 0.999 (makespan) or > 0.995
  (dollars), each differing makespan K a float32 tie (re-evaluated in
  float64 the two choices cost the same within 1e-6 relative).
- ``refine_info`` has ``repro``'s keys.  Note: ``repro``'s column-0 check
  fails at some configurations where its own refined tables equal its
  plain ones bit for bit (a single constrained model at J = 40, dt = 0.25,
  the closed-loop example's grid): XLA rounds the check's recomputation
  and the pre-sweep differently.  The port's check passes there, so only
  the keys and, where both verify, the plan and caps are compared.
"""
import numpy as np
import jax
import pytest
import torch

from repro.core import distributions as D
from repro.core import market as M
from repro.core import scenarios as SC
from repro.core.policies import checkpointing as C
from repro.core.policies.solver_backends import grids as G
from repro.core.policies.solver_backends import refine as R
from repro_torch.core import carry
from repro_torch.core import distributions as TD
from repro_torch.core import market as TM
from repro_torch.core import scenarios as TSC
from repro_torch.core.policies import checkpointing as TC
from repro_torch.core.policies.solver_backends import refine as TR

GRID, JOB, RO = 1.0 / 12.0, 60, 0.3     # repro's refine workload


@pytest.fixture(scope="module")
def dists():
    # constrained, memoryless, and a decreasing-hazard Weibull whose
    # run-to-completion argmins widen the caps
    return [D.constrained_for("n1-highcpu-16"), D.Exponential(mttf=8.0),
            D.Weibull(lam=0.12, k=0.8)]


@pytest.fixture(scope="module")
def tdists(dists):
    fams = ("constrained", "exponential", "weibull")
    return [carry.dist_from_numpy(f, {k: np.asarray(v)
                                      for k, v in vars(d).items()},
                                  device="cpu")
            for f, d in zip(fams, dists)]


@pytest.fixture(scope="module")
def price():
    # flat / crunch spike / ramp, 15-min cells over 16 h
    n = 64
    flat = np.full(n, 0.12)
    spike = np.full(n, 0.10)
    spike[12:28] = 0.55
    ramp = np.linspace(0.08, 0.40, n)
    return M.PriceGrid.from_prices(np.stack([flat, spike, ramp]), 0.25)


def _objective(name, price):
    return {} if name == "makespan" else dict(objective="dollars",
                                              price=price)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small solves issue thousands of tiny operations; with the suite's
    workers sharing the cores, one intra-op thread each avoids
    oversubscribing them (the DP's operations give the same bits at any
    thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain_cold(tdists, price):
    """The plain cold solve per (objective, delta), built once: what a
    cold refined solve must equal and what a warm one starts from."""
    cache = {}

    def get(objective, delta):
        if (objective, delta) not in cache:
            cache[objective, delta] = TC.solve_batch(
                tdists, JOB, grid_dt=GRID, restart_overhead=RO,
                delta_steps=delta, device="cpu",
                **_objective(objective, price))
        return cache[objective, delta]
    return get


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (60, 288, 1, 3, 4, None), (300, 1440, 1, 3, 4, None),
    (300, 1440, 2, 2, 3, 5), (40, 96, 1, 3, 4, 0), (15, 288, 1, 3, 4, None),
    (60, 12, 1, 3, 4, None), (300, 1440, 1, 1, 4, None),
    (60, 288, 1, 3, 1, None)])
def test_plan_matches_jax(args):
    assert TR.plan(*args) == R.plan(*args)


@pytest.mark.parametrize("j_max,t_max,delta", [
    (60, 288, 1), (300, 1440, 1), (300, 1440, 2), (40, 96, 1), (47, 50, 0),
    (48, 1440, 5), (5, 3, 1)])
def test_cone_segments_match_jax(j_max, t_max, delta):
    assert TR.cone_segments(j_max, t_max, delta) == \
        R.cone_segments(j_max, t_max, delta)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_caps_match_jax(seed):
    rng = np.random.default_rng(seed)
    j_max, t_max, factor, radius = 300, 1440, 4, 12
    segs = R.cone_segments(j_max, t_max, 1)
    jc, tc = 75, 360
    Kc = rng.integers(0, 8, size=(3, jc + 1, tc + 1)).astype(np.int32)
    Kc[:, :, -20:] = np.arange(jc + 1)[None, :, None]    # run to completion
    kw = dict(factor=factor, radius=radius, j_max_c=jc, t_max_c=tc)
    want = R.candidate_caps(Kc, segs, **kw)
    assert TR.candidate_caps(Kc, segs, **kw) == want
    assert TR.candidate_caps(torch.from_numpy(Kc), segs, **kw) == want


# ---------------------------------------------------------------------------
# refined == plain, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta", [1, 2])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("objective", ["makespan", "dollars"])
def test_refined_tables_bit_identical_to_plain(tdists, price, plain_cold,
                                               objective, start, delta):
    kw = dict(grid_dt=GRID, restart_overhead=RO, delta_steps=delta,
              device="cpu", **_objective(objective, price))
    cold = plain_cold(objective, delta)
    if start == "cold":
        v_init, n_sweeps, plain = None, 3, cold
    else:
        v_init, n_sweeps = cold.V, 2
        plain = TC.solve_batch(tdists, JOB, v_init=v_init, n_sweeps=2, **kw)
    # the in-process full check once per objective (it repeats the plain
    # solve this test compares with anyway)
    check = "full" if (start, delta) == ("cold", 1) else "col0"
    got = TC.solve_batch(tdists, JOB, v_init=v_init, n_sweeps=n_sweeps,
                         refine=True, refine_check=check, **kw)
    info = got.refine_info
    assert got.backend == "reference+refine"
    assert info["applied"] and info["verified_col0"] and not info["fallback"]
    assert info.get("full_check_match", True)
    assert torch.equal(got.V, plain.V) and torch.equal(got.K, plain.K)
    assert got.objective == objective
    got.validate()


def test_refined_warm_start_chain(tdists):
    """2 refined warm sweeps from a 3-sweep cold V equal the 5-sweep cold
    solve: sweeps couple only through column 0."""
    kw = dict(grid_dt=GRID, device="cpu")
    cold3 = TC.solve_batch(tdists, JOB, n_sweeps=3, **kw)
    warm = TC.solve_batch(tdists, JOB, n_sweeps=2, v_init=cold3.V,
                          refine=True, **kw)
    cold5 = TC.solve_batch(tdists, JOB, n_sweeps=5, **kw)
    assert warm.refine_info["verified_col0"]
    assert torch.equal(warm.V, cold5.V) and torch.equal(warm.K, cold5.K)


@pytest.mark.parametrize("objective", ["makespan", "dollars"])
def test_refined_fallback_on_forced_caps(tdists, price, plain_cold,
                                         objective, monkeypatch):
    """Every candidate cap 1: the pre-sweeps must miss argmins, the
    column-0 check must catch it, and the unrefined solve is served."""
    monkeypatch.setattr(TR, "candidate_caps",
                        lambda Kc, segs, **kw: (1,) * len(segs))
    kw = dict(grid_dt=GRID, restart_overhead=RO, device="cpu",
              **_objective(objective, price))
    got = TC.solve_batch(tdists, JOB, refine=True, **kw)
    plain = plain_cold(objective, 1)
    assert got.refine_info["caps"] == [1] * 6
    assert not got.refine_info["verified_col0"]
    assert got.refine_info["fallback"]
    assert torch.equal(got.V, plain.V) and torch.equal(got.K, plain.K)


def test_degenerate_plan_and_bad_arguments(tdists):
    small = TC.solve_batch(tdists, 6, grid_dt=1.0, refine=True, device="cpu")
    plain = TC.solve_batch(tdists, 6, grid_dt=1.0, device="cpu")
    assert small.refine_info == {"applied": False, "reason": "degenerate"}
    assert small.backend == "reference+refine"
    assert torch.equal(small.V, plain.V) and torch.equal(small.K, plain.K)
    one = TC.solve_batch(tdists, JOB, grid_dt=GRID, n_sweeps=1, refine=True,
                         device="cpu")
    assert one.refine_info == {"applied": False, "reason": "degenerate"}
    assert TC.solve_batch(tdists, 6, grid_dt=1.0,
                          device="cpu").refine_info is None
    with pytest.raises(ValueError, match="refine_check"):
        TC.solve_batch(tdists, JOB, grid_dt=GRID, refine=True,
                       refine_check="off", device="cpu")
    with pytest.raises(ValueError, match="unknown solver backend"):
        TC.solve_batch(tdists, JOB, grid_dt=GRID, refine=True,
                       backend="xla", device="cpu")


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------

def _makespan_cost(F, H, V, R_, j, t, i, grid_dt, t_max, delta):
    """Float64 cost of candidate interval ``i`` at (j, t)."""
    w = np.where(i == j, i, i + delta)
    end = np.minimum(t + w, t_max)
    Ft, Fe = F[t], F[end]
    p_fail = np.clip((Fe - Ft) / np.maximum(1.0 - Ft, G._EPS), 0.0, 1.0)
    dF = np.maximum(Fe - Ft, G._EPS)
    e_lost = np.clip((H[end] - H[t]) / dF - t * grid_dt, 0.0, w * grid_dt)
    return (1.0 - p_fail) * (w * grid_dt + V[j - i, end]) \
        + p_fail * (e_lost + R_[j])


@pytest.mark.parametrize("objective,delta,k_min", [
    ("makespan", 1, 0.999), ("makespan", 2, 0.999), ("dollars", 1, 0.995)])
def test_refined_tables_match_jax(dists, tdists, price, objective, delta,
                                  k_min):
    kw = dict(grid_dt=GRID, restart_overhead=RO, delta_steps=delta,
              refine=True, **_objective(objective, price))
    with jax.enable_x64(True):
        ref = C.solve_batch(dists, JOB, **kw)
        # the last sweep's restart costs come from the sweep before it
        prev = C.solve_batch(dists, JOB, **dict(kw, n_sweeps=2))
        grids = [G.cdf_grids(d, GRID) for d in dists]
    got = TC.solve_batch(tdists, JOB, device="cpu", **kw)
    assert ref.refine_info["verified_col0"] and got.refine_info[
        "verified_col0"]
    assert got.refine_info == ref.refine_info
    np.testing.assert_allclose(got.V.numpy(), ref.V, rtol=1e-5, atol=1e-5)
    K = got.K.numpy()
    assert (K == ref.K).mean() > k_min
    if objective == "makespan":
        for s, (Fc, Hc, t_max) in enumerate(grids):
            F, H = np.asarray(Fc, np.float64), np.asarray(Hc, np.float64)
            V = np.asarray(ref.V[s], np.float64)
            Rs = RO + np.asarray(prev.V[s, :, 0], np.float64)
            j, t = np.nonzero(K[s] != ref.K[s])
            a = _makespan_cost(F, H, V, Rs, j, t, K[s][j, t], GRID, t_max,
                               delta)
            b = _makespan_cost(F, H, V, Rs, j, t, ref.K[s][j, t], GRID,
                               t_max, delta)
            assert np.all(np.abs(a - b) <= 1e-6 * b), s


def test_refine_info_keys_match_jax(dists, tdists):
    with jax.enable_x64(True):
        ref = C.solve_batch(dists, JOB, grid_dt=GRID, refine=True)
        ref_full = C.solve_batch(dists, JOB, grid_dt=GRID, refine=True,
                                 refine_check="full")
        ref_small = C.solve_batch(dists, 6, grid_dt=1.0, refine=True)
    got = TC.solve_batch(tdists, JOB, grid_dt=GRID, refine=True,
                         device="cpu")
    got_full = TC.solve_batch(tdists, JOB, grid_dt=GRID, refine=True,
                              refine_check="full", device="cpu")
    got_small = TC.solve_batch(tdists, 6, grid_dt=1.0, refine=True,
                               device="cpu")
    assert got.refine_info.keys() == ref.refine_info.keys()
    assert got_full.refine_info.keys() == ref_full.refine_info.keys()
    assert got_small.refine_info == ref_small.refine_info
    assert ref.backend == "xla+refine" and got.backend == "reference+refine"


def test_repro_check_fails_where_its_tables_are_exact():
    """The reference-side fault the docstring names: at the closed-loop
    example's grid ``repro`` falls back although its caps cover the whole
    candidate axis and its refined tables equal its plain ones; the port
    verifies there with the same caps."""
    with jax.enable_x64(True):
        ref = C.solve_batch([D.constrained_for("n1-highcpu-2")], 40,
                            grid_dt=0.25, refine=True)
    got = TC.solve_batch([TD.constrained_for("n1-highcpu-2")], 40,
                         grid_dt=0.25, refine=True, device="cpu")
    assert ref.refine_info["caps"] == got.refine_info["caps"] == [40]
    assert ref.refine_info["fallback"] and not got.refine_info["fallback"]
    plain = TC.solve_batch([TD.constrained_for("n1-highcpu-2")], 40,
                           grid_dt=0.25, device="cpu")
    assert torch.equal(got.V, plain.V) and torch.equal(got.K, plain.K)


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

SWEEP = dict(job_steps=JOB, grid_dt=GRID, n_trials=60, seeds=(0, 1),
             device="cpu")


def _same_rows(a, b):
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k] == y[k] or (x[k] != x[k] and y[k] != y[k]) for k in x)
        for x, y in zip(a, b))


def test_sweep_checkpointing_refined_rows_equal_plain():
    scs = TSC.default_grid()[:3]
    assert _same_rows(TSC.sweep_checkpointing(scs, solver_refine=True,
                                              **SWEEP),
                      TSC.sweep_checkpointing(scs, **SWEEP))


@pytest.mark.parametrize("objective", ["makespan", "dollars"])
def test_market_refined_equals_plain(objective):
    scs = TSC.default_grid()[:4]
    mkt = TM.MarketModel.for_scenarios(scs)
    kw = dict(job_steps=JOB, grid_dt=GRID, dp_objective=objective,
              device="cpu")
    refined = TSC.solve_market_tables(scs, mkt, solver_refine=True, **kw)
    plain = TSC.solve_market_tables(scs, mkt, **kw)
    for regime, tab in refined.items():
        assert tab.refine_info["verified_col0"], regime
        assert torch.equal(tab.V, plain[regime].V)
        assert torch.equal(tab.K, plain[regime].K)
    sweep = dict(SWEEP, market=mkt, dp_objective=objective,
                 policies=("fixed", "cheapest"), seeds=(0,))
    assert _same_rows(TSC.sweep_market(scs, solver_refine=True, **sweep),
                      TSC.sweep_market(scs, **sweep))


def test_repro_market_refine_rows_match(monkeypatch):
    """``repro``'s ``sweep_market(solver_refine=True)`` and the port's, each
    solving its own tables: equal ``chosen`` and rows within the market
    contract for an own solve (rtol 1e-6)."""
    scs = SC.default_grid()[:2]
    kw = dict(job_steps=20, grid_dt=1.0 / 6.0, n_trials=50, seeds=(0,),
              policies=("fixed",), solver_refine=True)
    with jax.enable_x64(True):
        want = SC.sweep_market(scs, market=M.MarketModel.for_scenarios(scs),
                               **kw)
    tscs = TSC.default_grid()[:2]
    got = TSC.sweep_market(tscs, market=TM.MarketModel.for_scenarios(tscs),
                           device="cpu", **kw)
    for g, w in zip(got, want):
        assert g["chosen"] == w["chosen"]
        np.testing.assert_allclose(g["expected_dollars"],
                                   w["expected_dollars"], rtol=1e-6)
