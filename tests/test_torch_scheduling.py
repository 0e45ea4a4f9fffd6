"""Parity of the PyTorch port's scheduling-policy quantities (Eqs. 6-10,
Figs. 5-6) with ``repro.core.policies.scheduling`` (JAX under x64), on the
CPU, on shared float64 grids of job lengths T and start ages s made from a
seed.

Tolerances: rtol 1e-12 on every float64 function (only the last bits of
exp differ), with atol 1e-15 where a difference of two close CDF values or
a clip to 0 can leave a result near zero; the reuse decision and the
reuse tables (at L = 24, 20 and 30 h) are compared exactly, and
``linspace`` is bit-identical to ``jnp.linspace`` from start 0 and within
one ulp from other starts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as D
from repro.core import engine as E
from repro.core.policies import scheduling as S
from repro_torch.core import carry
from repro_torch.core import engine as TE
from repro_torch.core.policies import scheduling as TS

CASES = [
    ("constrained", D.constrained_for("n1-highcpu-16")),
    ("constrained", D.Constrained(tau1=0.6, tau2=0.75, b=24.0, A=0.5)),
    ("diurnal_constrained", D.diurnal_for("n1-highcpu-32", 20.0)),
    ("diurnal_constrained", D.diurnal_for("n1-highcpu-16", 8.0, A=0.44)),
]
IDS = [f"{fam}{i}" for i, (fam, _) in enumerate(CASES)]


def _port(family, d):
    return carry.dist_from_numpy(
        family, {f.name: np.asarray(getattr(d, f.name))
                 for f in dataclasses.fields(d)}, device="cpu")


def _grid():
    """(T, s) broadcast grids: job lengths 0.05-12 h and start ages 0-24 h,
    with the exact edges (age 0, windows that end at L, ages past L)."""
    rng = np.random.default_rng(7)
    T = np.concatenate([rng.uniform(0.05, 12.0, 23), [0.5, 2.0, 6.0]])
    s = np.concatenate([[0.0, 1e-3, 12.0, 22.0, 23.999, 24.0],
                        rng.uniform(0.0, 24.0, 31)])
    return T[:, None], s[None, :]


TWO_ARG = ["expected_wasted_work", "expected_makespan_new", "p_fail_new",
           "expected_runtime_increase", "capped_cdf"]
THREE_ARG = ["expected_makespan_at_age", "p_fail_existing_paper",
             "p_fail_existing", "job_failure_prob_memoryless",
             "job_failure_prob_policy"]


def _close(got, want):
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("fn", TWO_ARG)
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_functions_of_T_match_jax(case, fn):
    family, d = CASES[case]
    T, _ = _grid()
    with jax.enable_x64(True):
        want = np.asarray(getattr(S, fn)(d, jnp.asarray(T[:, 0])))
    _close(getattr(TS, fn)(_port(family, d), torch.from_numpy(T[:, 0])),
           want)


@pytest.mark.parametrize("fn", THREE_ARG)
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_functions_of_T_and_s_match_jax(case, fn):
    family, d = CASES[case]
    T, s = _grid()
    with jax.enable_x64(True):
        want = np.asarray(getattr(S, fn)(d, jnp.asarray(T), jnp.asarray(s)))
    got = getattr(TS, fn)(_port(family, d), torch.from_numpy(T),
                          torch.from_numpy(s))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("overhead", [0.0, 2.0 / 60.0])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_reuse_decision_matches_jax(case, overhead):
    family, d = CASES[case]
    T, s = _grid()
    with jax.enable_x64(True):
        want = np.asarray(S.reuse_decision(d, jnp.asarray(T), jnp.asarray(s),
                                           overhead))
    got = TS.reuse_decision(_port(family, d), torch.from_numpy(T),
                            torch.from_numpy(s), overhead)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    # at age 0 Eq. 10 is Eq. 9: never strictly better without an overhead
    assert overhead > 0 or not want[:, 0].any()


@pytest.mark.parametrize("policy", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_mean_failure_prob_over_starts_matches_jax(case, policy):
    family, d = CASES[case]
    T = np.array([0.25, 1.0, 2.0, 4.0, 8.0])
    with jax.enable_x64(True):
        want = np.asarray(S.mean_failure_prob_over_starts(
            d, jnp.asarray(T), n_starts=61, policy=policy))
    _close(TS.mean_failure_prob_over_starts(
        _port(family, d), torch.from_numpy(T), n_starts=61, policy=policy),
        want)


def test_linspace_matches_the_reuse_age_grid():
    """The reuse tables' age grid ``jnp.linspace(0, 24, 1441)`` and the
    Fig. 6b start ages, both to the bit."""
    with jax.enable_x64(True):
        ages = np.asarray(jnp.linspace(0.0, 24.0, 1441))
        starts = np.asarray(jnp.linspace(0.0, 24.0 * (1.0 - 1e-3), 241))
    assert np.array_equal(TS.linspace(0.0, 24.0, 1441), ages)
    assert np.array_equal(TS.linspace(0.0, 24.0 * (1.0 - 1e-3), 241), starts)


LINSPACE_ZERO = [(0.0, 24.0, 1441), (0.0, 20.0, 1441), (0.0, 30.0, 1441),
                 (0.0, 23.976, 241), (0.0, 1.0, 7), (0.0, 6.5, 2),
                 (0.0, -3.7, 333), (0.0, 48.0, 4801)]
LINSPACE_SHIFTED = [(1.5, 7.3, 101), (-2.0, 3.0, 17), (0.25, 24.0, 1000),
                    (3.0, 1.0, 50), (-7.1, 0.0, 64), (1e-3, 24.0, 2000)]


def _jnp_linspaces(start, stop, num):
    """``jnp.linspace`` under x64, eager and inside ``jax.jit`` (start and
    stop traced)."""
    with jax.enable_x64(True):
        eager = np.asarray(jnp.linspace(start, stop, num))
        jitted = np.asarray(jax.jit(jnp.linspace, static_argnums=2)(
            start, stop, num))
    return eager, jitted


@pytest.mark.parametrize("start,stop,num", LINSPACE_ZERO)
def test_linspace_from_zero_is_bit_identical(start, stop, num):
    got = TS.linspace(start, stop, num)
    for want in _jnp_linspaces(start, stop, num):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("start,stop,num", LINSPACE_SHIFTED)
def test_linspace_from_nonzero_start_within_one_ulp(start, stop, num):
    """At start != 0 XLA:CPU fuses some of the tree's operations into FMAs
    (which ones depends on num), numpy none: one ulp apart at most, the
    endpoints exact."""
    got = TS.linspace(start, stop, num)
    for want in _jnp_linspaces(start, stop, num):
        assert got[0] == want[0] and got[-1] == want[-1]
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


@pytest.mark.parametrize("L", [20.0, 30.0])
def test_reuse_tables_at_other_deadlines_match_jax(L):
    """``ReuseTables`` on the ``linspace(0, L, 1441)`` age grid, where the
    old ``(stop / div) * i`` grid put 1,132 (L = 20 h) and 1,430 (L = 30 h)
    of the 1,441 ages an ulp away from ``jnp.linspace``'s."""
    ds = [D.Constrained(tau1=1.0, tau2=0.8, b=L, A=0.475, L=L),
          D.Constrained(tau1=0.6, tau2=0.75, b=L, A=0.5, L=L)]
    vals = np.linspace(0.25, 0.6 * L, 23)
    with jax.enable_x64(True):
        want = E.ReuseTables(ds, vals)
    got = TE.ReuseTables([_port("constrained", d) for d in ds], vals,
                         device="cpu")
    assert got.L == want.L == L
    assert np.array_equal(got.tables, want.tables)


def test_policy_halves_failure_probability():
    """The paper's headline (Fig. 6b): for a ~2 h job the reuse policy's
    failure probability averaged over start ages is well below the
    memoryless baseline's."""
    d = _port("constrained", D.constrained_for("n1-highcpu-16"))
    T = torch.tensor([2.0], dtype=torch.float64)
    pol = float(TS.mean_failure_prob_over_starts(d, T, policy=True)[0])
    mem = float(TS.mean_failure_prob_over_starts(d, T, policy=False)[0])
    assert 0.0 < pol < mem
