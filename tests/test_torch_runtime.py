"""The closed loop in the PyTorch port (``fault/injection.py``,
``core/simulator.py``, ``core/online.py``, ``core/tonks.py``,
``core/runtime.py``) against ``repro`` on the CPU.

Contracts:
- The fault injector (host numpy, copied): schedules, storm lifetimes,
  stage-fault budgets and logs equal.
- ``OnlineModelTracker`` on one shared observation sequence: the same
  refits, change points and KS cuts; ``last_ks`` rtol 1e-6 and the model's
  theta rtol 1e-7 (the fitting contract, JAX under x64).
- The simulator: the age grid equal; the grid CDF within rtol 1e-12 in
  float64 and, in float32 (JAX with x64 off; ``cumsum`` sums in another
  order), within rtol 1e-6 plus half a float32 ulp of 1 absolute
  (``1 - exp(-cum)`` rounds near 1, so at F ~ 1e-3 one rounding is 4e-5
  relative); lifetimes from shared uniforms within 1e-5 h in float64 and
  1e-4 h in float32 (where the CDF is flat, one float32 ulp of F moves its
  inverse by ~2e-5 h); the port's own ``generate_fleet_trace``, drawn from
  a ``torch.Generator``, against ``repro``'s threefry trace by a two-sample
  KS test at n = 1,516.
- Tonks: the exact quantities equal under x64, the histogram's counts
  equal ``jnp.histogram``'s on shared data, the Monte-Carlo estimates
  within ``tests/test_tonks.py``'s tolerances.
- ``FleetRuntime`` fed two identically seeded ``repro`` ``FleetStream``s
  (``examples/fleet_runtime.py``'s quick config, ``default_schedule(320)``),
  with and without ``solver_refine``: equal events, swaps, retries,
  ``degraded`` and adaptation lag; live tables at the DP contract (V
  within rtol = atol = 1e-5, K agreement > 0.999); regret rtol 1e-6 (the
  probe's pools come from the same ``default_rng`` streams).  The dollar
  objective with a ``PriceFeed`` streams the same dollars.
- The warm-start identity: warm sweeps from a cold V equal the longer cold
  solve bit for bit, refined or not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro import fault as F
from repro.core import market as M
from repro.core import online as O
from repro.core import runtime as R
from repro.core import simulator as S
from repro.core import tonks as T
from repro_torch import fault as TF
from repro_torch.core import distributions as TD
from repro_torch.core import fitting
from repro_torch.core import market as TM
from repro_torch.core import online as TO
from repro_torch.core import runtime as TR
from repro_torch.core import simulator as TS
from repro_torch.core import tonks as TT
from repro_torch.core.policies import checkpointing as TC

N_OBS = 320
QUICK = dict(job_steps=40, grid_dt=0.25, window=128, refit_every=32,
             min_samples=48, stream_block=128,
             stream_vm_types=("n1-highcpu-2",), regret_trials=64,
             retry_backoff_obs=8, max_retries=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The loop issues thousands of tiny operations; with the suite's
    workers sharing the cores, one intra-op thread each avoids
    oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(schedule):
    return [(e.kind, e.at_obs, e.duration, e.param) for e in schedule]


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 20, 320, 400, 1200])
def test_default_schedule_matches_jax(n):
    assert _events(TF.default_schedule(n)) == _events(F.default_schedule(n))


def test_injector_replays_like_jax():
    sched = F.default_schedule(400)
    a = F.FaultInjector(sched, seed=3)
    b = TF.FaultInjector(TF.default_schedule(400), seed=3)
    storm = next(e for e in sched if e.kind == "storm")
    tstorm = next(e for e in b.schedule if e.kind == "storm")
    for obs in range(400):
        da, db = a.drift_event(obs), b.drift_event(obs)
        assert (da is None) == (db is None)
        sa, sb = a.storm_active(obs), b.storm_active(obs)
        assert (sa is None) == (sb is None)
        if sa is not None:
            assert a.storm_lifetime(sa) == b.storm_lifetime(sb)
        for kind in ("fit_divergence", "solve_timeout"):
            assert a.take(kind, obs) == b.take(kind, obs)
    assert a.log == b.log and a.counts() == b.counts()
    pinned = TF.FaultEvent("storm", 0, param={"lifetime_hours": 0.2})
    assert b.storm_lifetime(pinned) == 0.2
    assert b.storm_lifetime(tstorm) == a.storm_lifetime(storm)
    with pytest.raises(ValueError, match="unknown fault kind"):
        TF.FaultEvent("flood", 0)
    with pytest.raises(ValueError, match="at_obs"):
        TF.FaultEvent("storm", -1)


# ---------------------------------------------------------------------------
# the online tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(0.01, 64, None), (0.01, 64, 128),
                                  (0.05, 17, 300)])
def test_ks_critical_value_matches_jax(args):
    assert TO.ks_critical_value(*args) == O.ks_critical_value(*args)


def _drifting_lifetimes():
    """300 lifetimes of n1-highcpu-2's Eq. 1 fit, then 200 of a harsh
    regime (most VMs preempted within hours): one float64 sequence both
    trackers observe."""
    u = np.random.default_rng(7).uniform(size=500)
    a = TD.constrained_for("n1-highcpu-2").icdf(torch.from_numpy(u[:300]))
    b = TD.Constrained(tau1=0.4, tau2=0.75, b=24.0, A=0.8).icdf(
        torch.from_numpy(u[300:]))
    return np.concatenate([a.numpy(), b.numpy()])


def test_online_tracker_matches_jax():
    kw = dict(window=128, refit_every=32, min_samples=48)
    ref = O.OnlineModelTracker(**kw)
    got = TO.OnlineModelTracker(**kw, device="cpu")
    with jax.enable_x64(True):
        for x in _drifting_lifetimes():
            assert got.observe(x) == ref.observe(x)
            assert got.last_cut == ref.last_cut
            np.testing.assert_allclose(got.last_ks, ref.last_ks, rtol=1e-6)
    assert got.n_refits == ref.n_refits > 5
    assert got.change_points == ref.change_points >= 1
    assert got.drifted == ref.drifted
    for f in ("tau1", "tau2", "b", "A"):
        np.testing.assert_allclose(float(getattr(got.model, f)),
                                   float(getattr(ref.model, f)), rtol=1e-7)


def test_online_tracker_rejects_diverged_and_degenerate_fits():
    nan = torch.tensor(float("nan"), dtype=torch.float64)

    def diverged(family, data):
        return fitting.FitResult(dist=None, theta=nan.expand(3), lse=nan,
                                 iterations=0, converged=False)

    tr = TO.OnlineModelTracker(window=64, refit_every=8, min_samples=8,
                               fit_fn=diverged, device="cpu")
    prior = tr.model
    with pytest.raises(Exception, match="non-finite"):
        for x in _drifting_lifetimes()[:8]:
            tr.observe(x)
    assert tr.model is prior and tr.n_refits == 0
    tr = TO.OnlineModelTracker(window=64, refit_every=8, min_samples=8,
                               device="cpu")
    with pytest.raises(ValueError, match="constant trace"):
        for _ in range(8):
            tr.observe(0.02)
    tr.defer_refit(5)
    assert not any(tr.observe(0.02 + 0.01 * k) for k in range(4))


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("vm,clock,idle", [
    ("n1-highcpu-2", 12.0, False), ("n1-highcpu-32", 20.0, False),
    ("n1-highcpu-16", 3.5, True)])
def test_ground_truth_matches_jax(x64, vm, clock, idle):
    dtype = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        g = S.ground_truth_for(vm, clock, idle)
        t, Fg = (np.asarray(a) for a in g._grid())
        u = np.random.default_rng(1).uniform(1e-6, 1 - 1e-9, 4000).astype(
            Fg.dtype)
        # the body of repro's sample(), on shared uniforms
        want = np.array(jnp.where(
            u >= Fg[-1], g.L,
            jnp.interp(jnp.minimum(jnp.asarray(u), Fg[-1] - 1e-7), Fg, t)))
        x = np.linspace(-1.0, 25.0, 301).astype(Fg.dtype)
        cdf = np.asarray(g.cdf(jnp.asarray(x)))
        haz = np.asarray(g.hazard(jnp.asarray(x[1:-1])))
    tg = TS.ground_truth_for(vm, clock, idle, dtype=dtype)
    tt, tF = tg._grid("cpu")
    assert np.array_equal(tt.numpy(), t)
    # 1 - exp(-cum) rounds near 1: half a float32 ulp there is absolute
    rtol, atol = (1e-12, 0.0) if x64 else (1e-6, 0.5 * np.spacing(
        np.float32(1.0)))
    np.testing.assert_allclose(tF.numpy(), Fg, rtol=rtol, atol=atol)
    np.testing.assert_allclose(tg.cdf(torch.from_numpy(x)).numpy(), cdf,
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(tg.hazard(torch.from_numpy(x[1:-1])).numpy(),
                               haz, rtol=1e-5 if not x64 else 1e-12)
    got = tg.from_uniforms(torch.from_numpy(u)).numpy()
    assert got.dtype == want.dtype and 0 < got.min() and got.max() <= 24.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if x64 else 1e-4)


def test_batched_ground_truth_equals_its_rows():
    clocks = torch.tensor([[3.0], [14.5], [22.0]])
    rows = TS.GroundTruth(h0=torch.tensor([[0.2], [0.45], [0.6]]),
                          launch_clock=clocks)
    u = torch.rand((3, 50), generator=torch.Generator().manual_seed(0))
    got = rows.from_uniforms(u)
    for k, h0 in enumerate((0.2, 0.45, 0.6)):
        one = TS.GroundTruth(h0=h0, launch_clock=float(clocks[k, 0]))
        assert torch.equal(got[k], one.from_uniforms(u[k]))


def test_fleet_trace_matches_jax_statistically():
    vm_types = TS.FLEET_VM_TYPES
    want = S.generate_fleet_trace(jax.random.PRNGKey(0), n_vms=1516,
                                  vm_types=vm_types)
    got = TS.generate_fleet_trace(torch.Generator().manual_seed(0),
                                  n_vms=1516, vm_types=vm_types)
    assert got.lifetime.shape == (1516,) and got.lifetime.dtype == \
        torch.float32
    life = got.lifetime.numpy()
    assert 0 < life.min() and life.max() <= 24.0
    assert stats.ks_2samp(life, np.asarray(want.lifetime)).pvalue > 0.01
    counts = np.bincount(got.vm_type_idx.numpy(), minlength=5)
    assert counts.min() > 1516 / 5 * 0.8
    assert 0.0 <= float(got.launch_clock.min()) \
        and float(got.launch_clock.max()) < 24.0
    # each VM draws from its own type's process at its own clock
    one = TS.trace_for(torch.Generator().manual_seed(1), "n1-highcpu-32",
                       n=1516)
    ref = S.trace_for(jax.random.PRNGKey(1), "n1-highcpu-32", n=1516)
    assert stats.ks_2samp(one.numpy(), np.asarray(ref)).pvalue > 0.01


def test_fleet_stream_regime_switch():
    s = TR.FleetStream(seed=0, block=64, vm_types=("n1-highcpu-2",),
                       device="cpu")
    a = [s.next() for _ in range(40)]
    s.set_regime(("n1-highcpu-32",))
    b = [s.next() for _ in range(200)]
    assert len(s._buf) == 64 - 200 % 64 and s.vm_types == ("n1-highcpu-32",)
    assert all(0 < x <= 24.0 for x in a + b)
    again = TR.FleetStream(seed=0, block=64, vm_types=("n1-highcpu-2",),
                           device="cpu")
    assert [again.next() for _ in range(40)] == a


# ---------------------------------------------------------------------------
# Tonks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,L,w", [(3, 24.0, 0.5), (6, 24.0, 0.3),
                                   (5, 23.7, 0.3), (40, 24.0, 0.7)])
def test_tonks_exact_quantities_match_jax(N, L, w):
    with jax.enable_x64(True):
        z, p = T.partition_function(N, L, w), T.p_boundary(N, L, w)
    np.testing.assert_allclose(
        float(TT.partition_function(N, L, w, device="cpu")), float(z),
        rtol=1e-14)
    assert float(TT.p_boundary(N, L, w, device="cpu")) == float(p)
    # a tensor argument carries its own device
    assert float(TT.p_boundary(N, torch.tensor(L, dtype=torch.float64),
                               w)) == float(p)


def test_tonks_histogram_matches_jax():
    x = np.concatenate([np.random.default_rng(0).uniform(-1, 25, 5000),
                        [0.0, 24.0, 12.0, 0.5, -0.0]])
    with jax.enable_x64(True):
        edges = jnp.linspace(0.0, 24.0, 49)
        want, _ = jnp.histogram(jnp.asarray(x), bins=edges)
    got = TT.histogram(torch.from_numpy(x),
                       torch.from_numpy(np.array(edges)))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_tonks_monte_carlo_within_repro_tolerances():
    gen = torch.Generator().manual_seed(0)
    mc, exact = TT.boundary_enhancement(gen, 300000, N=6, L=24.0, w=0.3)
    np.testing.assert_allclose(float(mc), float(exact), rtol=0.1)
    N, L, w = 6, 24.0, 0.3
    c, rho = TT.start_density(torch.Generator().manual_seed(1), 60000, N=N,
                              L=L, w=w, n_bins=48)
    rho = rho.numpy()
    enhanced = 1.0 / (L - N * w)
    np.testing.assert_allclose(rho[0], enhanced, rtol=0.1)
    np.testing.assert_allclose(rho[16:32].mean(), enhanced, rtol=0.1)
    np.testing.assert_allclose(rho.sum() * (L / 48), 1.0, rtol=0.02)
    assert c.shape == (48,)
    x = TT.sample_configurations(torch.Generator().manual_seed(2), 2000, 5,
                                 24.0, 0.5)
    assert torch.diff(x, dim=1).min() >= 0.5 - 1e-9
    assert float(x.max()) <= 24.0 - 0.5 + 1e-9
    with pytest.raises(ValueError, match="N\\*w < L"):
        TT.sample_configurations(gen, 2, 50, 24.0, 0.5)


# ---------------------------------------------------------------------------
# the closed loop against repro
# ---------------------------------------------------------------------------

def _jax_stream():
    return R.FleetStream(seed=0, block=QUICK["stream_block"],
                         vm_types=QUICK["stream_vm_types"])


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "refine"])
def runs(request):
    """repro's and the port's runtime on two identically seeded repro
    streams, under x64 (the fit's float64)."""
    cfg = dict(QUICK, solver_refine=request.param)
    with jax.enable_x64(True):
        ref = R.FleetRuntime(R.RuntimeConfig(**cfg),
                             injector=F.FaultInjector(
                                 F.default_schedule(N_OBS), seed=0),
                             stream=_jax_stream())
        ref_rep = ref.run(N_OBS)
        got = TR.FleetRuntime(TR.RuntimeConfig(**cfg),
                              injector=TF.FaultInjector(
                                  TF.default_schedule(N_OBS), seed=0),
                              stream=_jax_stream(), device="cpu")
        got_rep = got.run(N_OBS)
    return ref, ref_rep, got, got_rep


def test_runtime_matches_jax(runs):
    ref, want, got, rep = runs
    assert rep.events == want.events
    assert rep.retries == want.retries == {"fit": 2, "solve": 1}
    assert rep.degraded == want.degraded
    assert (rep.n_obs, rep.n_refits, rep.change_points, rep.stale_obs_total,
            rep.adaptation_lag_obs) == (
        want.n_obs, want.n_refits, want.change_points, want.stale_obs_total,
        want.adaptation_lag_obs)
    assert rep.adaptation_lag_obs is not None
    assert len(rep.swaps) == len(want.swaps) >= 2
    for a, b in zip(rep.swaps, want.swaps):
        assert (a.obs, a.reason, a.warm, a.stale_obs, a.lag_from_drift) == (
            b.obs, b.reason, b.warm, b.stale_obs, b.lag_from_drift)
        assert (a.regret_hours is None) == (b.regret_hours is None)
        if a.regret_hours is not None:
            np.testing.assert_allclose(a.regret_hours, b.regret_hours,
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(a.regret_frac, b.regret_frac,
                                       rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.live_tables.V.numpy(),
                               ref.live_tables.V, rtol=1e-5, atol=1e-5)
    assert (got.live_tables.K.numpy() == ref.live_tables.K).mean() > 0.999
    backend = "reference+refine" if got.cfg.solver_refine else "reference"
    assert got.live_tables.backend == backend
    if got.cfg.solver_refine:
        assert got.live_tables.refine_info["applied"]


def test_runtime_evaluate_matches_jax(runs):
    ref, _, got, _ = runs
    with jax.enable_x64(True):
        want = ref.evaluate(n_trials=64)
    rows = got.evaluate(n_trials=64)
    assert [(r["scenario"], r["policy"]) for r in rows] == \
        [(r["scenario"], r["policy"]) for r in want]
    for a, b in zip(rows, want):
        assert a["unfinished_frac"] == b["unfinished_frac"]
        for k in ("makespan_mean", "makespan_p50", "expected_makespan_dp",
                  "p_fail_fresh"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5)


def test_runtime_dollar_objective_matches_jax():
    cfg = dict(QUICK, dp_objective="dollars", regret_trials=32)
    n = 120
    with jax.enable_x64(True):
        ref = R.FleetRuntime(R.RuntimeConfig(**cfg),
                             price_feed=M.PriceFeed(seed=4),
                             stream=_jax_stream())
        want = ref.run(n)
        got_rt = TR.FleetRuntime(TR.RuntimeConfig(**cfg),
                                 price_feed=TM.PriceFeed(seed=4),
                                 stream=_jax_stream(), device="cpu")
        got = got_rt.run(n)
    assert got.events == want.events and len(got.swaps) >= 1
    assert got.dollars_streamed == want.dollars_streamed > 0
    assert got.vm_hours_streamed == want.vm_hours_streamed
    assert got.mean_price == want.mean_price
    assert got_rt.live_tables.objective == "dollars"
    np.testing.assert_allclose(got_rt.live_tables.V.numpy(),
                               ref.live_tables.V, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="price_feed"):
        TR.FleetRuntime(TR.RuntimeConfig(**cfg), device="cpu")


@pytest.mark.parametrize("refine", [False, True])
def test_warm_start_identity(refine):
    """Warm sweeps from a cold V continue the cold sweep sequence bit for
    bit: 2 warm sweeps from the 3-sweep bootstrap equal the 5-sweep cold
    solve, and 1 from a 3-sweep V the 4-sweep one."""
    cfg = TR.RuntimeConfig(**dict(QUICK, solver_refine=refine))
    fr = TR.FleetRuntime(cfg, stream=_jax_stream(), device="cpu")
    dists = fr._dists()
    kw = dict(grid_dt=cfg.grid_dt, device="cpu")
    tab = fr._solve(warm=True)
    assert fr._last_solve_warm
    want = TC.solve_batch(dists, cfg.job_steps, n_sweeps=5, **kw)
    assert torch.equal(tab.V, want.V) and torch.equal(tab.K, want.K)
    cold3 = TC.solve_batch(dists, cfg.job_steps, n_sweeps=3, **kw)
    one = TC.solve_batch(dists, cfg.job_steps, n_sweeps=1, v_init=cold3.V,
                         refine=refine, **kw)
    cold4 = TC.solve_batch(dists, cfg.job_steps, n_sweeps=4, **kw)
    assert torch.equal(one.V, cold4.V) and torch.equal(one.K, cold4.K)


def test_runtime_on_its_own_stream():
    """The port's FleetStream (torch.Generator draws) through the default
    fault schedule: the drift is detected and answered by a warm swap, and
    the envelope absorbs the injected faults."""
    rt = TR.FleetRuntime(TR.RuntimeConfig(**QUICK),
                         injector=TF.FaultInjector(
                             TF.default_schedule(N_OBS), seed=0),
                         device="cpu")
    rep = rt.run(N_OBS)
    assert rep.retries == {"fit": 2, "solve": 1}
    assert rep.adaptation_lag_obs is not None and not rep.degraded
    assert any(s.reason == "change-point" and s.warm for s in rep.swaps)
    assert rep.regret_hours is not None and np.isfinite(rep.regret_hours)
    kinds = {k for _, k, _ in rep.events}
    assert {"drift-injected", "fit-failure", "change-point",
            "solve-failure", "table-swap"} <= kinds
