"""Parity of the PyTorch port's lifetime-model fitting (the paper's Eq. 1
fit, Fig. 1) with ``repro.core.fitting`` (JAX under x64), on the CPU, on
shared numpy inputs.

Tolerances:
- New families and base methods pointwise: rtol 1e-12 (float64 on both
  sides; only the last bits of exp differ).  ``Empirical``'s interpolation
  is bit-identical (the same subtractions, division and product).
- Fits on one shared trace (1,516 lifetimes of the n1-highcpu-16 fit, the
  Fig. 1 size): the converging families (constrained, exponential,
  Weibull) take the same iterations, converge alike, and agree on theta
  within rtol 1e-7 and on the LSE within rtol 1e-9.
- Gompertz-Makeham: both sides follow one trajectory for 10 iterations
  (theta within rtol 1e-9).  The eleventh step solves a system whose
  condition number is ~1e16, so last-bit differences in the Jacobian
  send the two fits to different points.  ``repro`` then stops at a point
  where JAX's forward-mode Jacobian is NaN in every column (its rule for
  ``alpha / beta`` multiplies 0 by the inverse of an underflowed
  ``beta**2``).  From there it takes zero steps to its 200th iteration
  and ends not converged, LSE ~62.  ``torch.func``'s rule stays finite
  there, so the port reaches the exponential limit of the family
  (``alpha -> 0``), converged.  The test holds the shared prefix, repro's
  NaN Jacobian against the port's finite one at the same point, and the
  port's LSE at the exponential fit's within rtol 1e-8 and at most
  repro's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as D
from repro.core import fitting as F
from repro_torch.core import carry
from repro_torch.core import distributions as TD
from repro_torch.core import fitting as TF

CONVERGING = ("constrained", "exponential", "weibull")


def _fields(d):
    return {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d)}


def _port(family, d):
    return carry.dist_from_numpy(family, _fields(d), device="cpu")


@pytest.fixture(scope="module")
def trace():
    """The Fig. 1 trace size: 1,516 lifetimes of the n1-highcpu-16 fit,
    inverted from ``default_rng(42)`` uniforms."""
    u = np.random.default_rng(42).uniform(size=1516)
    return TD.constrained_for("n1-highcpu-16").icdf(
        torch.from_numpy(u)).numpy()


@pytest.fixture(scope="module")
def fits(trace):
    with jax.enable_x64(True):
        want = F.fit_all(trace)
    return want, TF.fit_all(trace, device="cpu")


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------

CASES = [
    ("gompertz_makeham", D.GompertzMakeham()),
    ("gompertz_makeham", D.GompertzMakeham(lam=0.02, alpha=3e-3, beta=0.2)),
    ("uniform", D.Uniform()),
    ("uniform", D.Uniform(L=20.0)),
    ("constrained", D.constrained_for("n1-highcpu-32")),
    ("exponential", D.Exponential(mttf=8.0)),
    ("weibull", D.Weibull(lam=0.12, k=0.8)),
]
IDS = [f"{fam}{i}" for i, (fam, _) in enumerate(CASES)]


def _ages(n=97):
    t = np.random.default_rng(1).uniform(0.05, 24.0, n)
    return np.concatenate([t, [0.0, 0.5, 12.0, 23.99, 24.0, 26.0]])


@pytest.mark.parametrize("method", ["cdf", "pdf", "hazard", "survival"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_pointwise_methods_match_jax(case, method):
    family, d = CASES[case]
    t = _ages()
    with jax.enable_x64(True):
        want = np.asarray(getattr(d, method)(jnp.asarray(t)))
    got = getattr(_port(family, d), method)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_interval_methods_match_jax(case):
    family, d = CASES[case]
    rng = np.random.default_rng(2)
    a = rng.uniform(0.0, 20.0, 31)
    b = a + rng.uniform(0.0, 6.0, 31)
    pd = _port(family, d)
    with jax.enable_x64(True):
        want = [np.asarray(d.partial_expectation(jnp.asarray(a),
                                                 jnp.asarray(b))),
                np.asarray(d.fail_between(jnp.asarray(a), jnp.asarray(b))),
                float(d.expected_lifetime()),
                float(d.mean_lifetime_capped())]
    got = [pd.partial_expectation(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy(),
           pd.fail_between(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
           float(pd.expected_lifetime()), float(pd.mean_lifetime_capped())]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)


def test_registry_lists_the_new_families():
    reg = TD.registry()
    for name in ("gompertz_makeham", "uniform", "empirical"):
        assert name in reg
    assert reg["gompertz_makeham"] is TD.GompertzMakeham


def test_empirical_interp_edges_and_duplicate_knots():
    """``cdf``/``quantile`` below the first knot, above the last, at every
    knot, between knots and across duplicated knots (and duplicated ECDF
    values), to the bit."""
    s = np.array([5.0, 1.0, 2.0, 2.0, 2.0, 3.0, 5.0, 8.0, 8.0, 23.5])
    with jax.enable_x64(True):
        je = D.Empirical.from_samples(s)
        te = TD.Empirical.from_samples(s)
        assert np.array_equal(te.knots.numpy(), np.asarray(je.knots))
        assert np.array_equal(te.values.numpy(), np.asarray(je.values))
        t = np.concatenate([[-1.0, 0.0, 0.5, 30.0, 24.0], np.unique(s),
                            np.unique(s) + 0.25, np.nextafter(np.unique(s),
                                                              0.0)])
        q = np.array([0.0, 0.01, 0.05, 0.1, 0.2, 0.25, 0.5, 0.7, 0.95, 0.99,
                      1.0, 1.5, -0.2])
        want_c = np.asarray(je.cdf(jnp.asarray(t)))
        want_q = np.asarray(je.quantile(jnp.asarray(q)))
        want_pdf = np.asarray(je.pdf(jnp.asarray(t)))
    assert np.array_equal(te.cdf(torch.from_numpy(t)).numpy(), want_c)
    assert np.array_equal(te.quantile(torch.from_numpy(q)).numpy(), want_q)
    np.testing.assert_allclose(te.pdf(torch.from_numpy(t)).numpy(),
                               want_pdf, rtol=1e-12, atol=1e-15)
    assert want_c[0] == 0.0 and want_c[3] == 1.0 and want_q[-2] == 24.0


def test_sample_draws_from_the_model():
    """``sample`` through an explicit generator: lifetimes in [0, L], the
    residual mass ``1 - F(L)`` preempted at exactly L, the rest following
    the CDF conditioned on ``t < L`` (KS distance within 1.63/sqrt(n), the
    1 % critical value), and
    the same generator seed giving the same draws."""
    d = TD.Constrained(tau1=1.2, tau2=0.7, b=24.0, A=0.45)
    n = 20000
    x = d.sample(torch.Generator().manual_seed(5), (n,))
    y = d.sample(torch.Generator().manual_seed(5), (n,))
    assert x.dtype == torch.float64 and x.shape == (n,)
    assert torch.equal(x, y)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 24.0
    capped = float((x == 24.0).double().mean())
    atom = 1.0 - float(d.cdf(24.0))
    assert atom > 0.05
    assert abs(capped - atom) < 4.0 * np.sqrt(atom * (1 - atom) / n)
    # below the cap, F(x) / F(L) is uniform on [0, 1]
    below = x[x < 24.0]
    ks = float(TF.ks_statistic(TD.Uniform(L=1.0),
                               d.cdf(below) / d.cdf(24.0)))
    assert ks < 1.63 / np.sqrt(below.numel())


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", CONVERGING)
def test_converging_fits_match_jax(fits, family):
    want, got = fits
    w, g = want[family], got[family]
    assert bool(w.converged) and g.converged
    assert g.iterations == int(w.iterations)
    np.testing.assert_allclose(g.theta.numpy(), np.asarray(w.theta),
                               rtol=1e-7, atol=0)
    np.testing.assert_allclose(float(g.lse), float(w.lse), rtol=1e-9)
    assert type(g.dist).__name__ == type(w.dist).__name__


def test_constrained_fit_wins(fits, trace):
    """Fig. 1: Eq. 1 has the lowest LSE of the four and a KS well below
    the baselines', as in ``repro``."""
    _, got = fits
    ours = got["constrained"]
    for name in ("exponential", "weibull", "gompertz_makeham"):
        assert float(ours.lse) < 0.2 * float(got[name].lse), name
        assert float(TF.ks_statistic(ours.dist, trace)) < \
            0.5 * float(TF.ks_statistic(got[name].dist, trace)), name


def test_gompertz_makeham_fit(fits, trace):
    want, got = fits
    fam, jfam = TF.FAMILIES["gompertz_makeham"], F.FAMILIES["gompertz_makeham"]
    emp = TD.Empirical.from_samples(trace)
    t, y = emp.knots, emp.values
    L = torch.tensor(24.0, dtype=torch.float64)

    def res(theta):
        d = fam.build(theta, L)
        return torch.cat([TF._model_cdf(d)(t) - y, fam.boundary(d)])

    with jax.enable_x64(True):
        jt, jy, jL = jnp.asarray(t.numpy()), jnp.asarray(y.numpy()), \
            jnp.asarray(24.0)

        def jres(theta):
            d = jfam.build(theta, jL)
            return jnp.concatenate([F._model_cdf(d)(jt) - jy,
                                    jfam.boundary(d)])

        for init, jinit in zip((fam.theta0, *fam.extra_theta0),
                               (jfam.theta0, *jfam.extra_theta0)):
            a = TF.levenberg_marquardt(res, init(t, y, L), max_iters=10)
            b = F.levenberg_marquardt(jres, jinit(jt, jy, jL), max_iters=10)
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b[0]),
                                       rtol=1e-9, atol=0)
            np.testing.assert_allclose(float(a[1]), float(b[1]), rtol=1e-9)
        stuck = np.asarray(want["gompertz_makeham"].theta)
        J_jax = np.asarray(jax.jacfwd(jres)(jnp.asarray(stuck)))
    J_port = torch.func.jacfwd(res)(torch.from_numpy(stuck.copy()))
    assert np.isnan(J_jax).any(axis=0).all()
    assert bool(torch.isfinite(J_port).all())
    w, g = want["gompertz_makeham"], got["gompertz_makeham"]
    assert not bool(w.converged) and int(w.iterations) == 200
    assert g.converged
    np.testing.assert_allclose(float(g.lse), float(got["exponential"].lse),
                               rtol=1e-8)
    assert float(g.lse) <= float(w.lse)


def test_fit_on_points_and_iteration_cap():
    """``fit`` on (t, y) points with a cap of 3 iterations: both sides stop
    at the cap, not converged, at the same theta."""
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0.1, 23.0, 200))
    y = np.asarray(D.constrained_for("n1-highcpu-8").cdf(t)) \
        + rng.normal(0.0, 0.01, 200)
    with jax.enable_x64(True):
        want = F.fit("weibull", t, y, max_iters=3)
    got = TF.fit("weibull", t, y, max_iters=3, device="cpu")
    assert got.iterations == int(want.iterations) == 3
    assert not got.converged and not bool(want.converged)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=1e-9)


def test_fit_samples_rejects_degenerate_traces():
    for bad, match in (([], "empty"), ([1.0, np.nan], "non-finite"),
                       ([24.0, 24.0, 25.0], "deadline cap"),
                       ([3.0, 3.0, 3.0], "constant trace")):
        with pytest.raises(ValueError, match=match):
            TF.fit_samples("constrained", bad, device="cpu")


def test_singular_jtj_takes_a_zero_step():
    """At theta = (0, 0) the Jacobian of sqrt(theta0 * theta1) is NaN, so
    the damped system is singular: every step is zeroed, theta never
    leaves its start (non-finite entries zeroed on entry), and the run
    ends at its cap, not converged - on both sides."""
    def res(theta):
        return torch.sqrt(theta[0] * theta[1]) + torch.tensor(
            [1.0, 2.0], dtype=torch.float64)

    def jres(theta):
        return jnp.sqrt(theta[0] * theta[1]) + jnp.asarray([1.0, 2.0])

    theta, loss, iters, conv = TF.levenberg_marquardt(
        res, torch.tensor([0.0, np.nan], dtype=torch.float64), max_iters=7)
    with jax.enable_x64(True):
        jt, jl, ji, jc = F.levenberg_marquardt(
            jres, jnp.asarray([0.0, np.nan]), max_iters=7)
    assert torch.equal(theta, torch.zeros(2, dtype=torch.float64))
    assert np.array_equal(np.asarray(jt), np.zeros(2))
    assert iters == int(ji) == 7 and not conv and not bool(jc)
    assert float(loss) == float(jl) == 5.0


def test_goodness_of_fit_matches_jax(trace):
    jd = D.constrained_for("n1-highcpu-16")
    td = _port("constrained", jd)
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0.0, 24.0, 50))
    y = np.clip(np.asarray(jd.cdf(t)) + rng.normal(0, 0.02, 50), 0, 1)
    with jax.enable_x64(True):
        ks = float(F.ks_statistic(jd, trace))
        ls = float(F.lse(jd, t, y))
        q, eq, mq = (np.asarray(x) for x in F.qq_points(jd, trace))
    np.testing.assert_allclose(float(TF.ks_statistic(td, trace)), ks,
                               rtol=1e-12)
    np.testing.assert_allclose(float(TF.lse(td, t, y)), ls, rtol=1e-12)
    tq, teq, tmq = (x.numpy() for x in TF.qq_points(td, trace))
    np.testing.assert_allclose(tq, q, rtol=1e-15)
    np.testing.assert_allclose(teq, eq, rtol=1e-15)
    np.testing.assert_allclose(tmq, mq, rtol=1e-10)
