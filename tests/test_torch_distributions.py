"""Parity of the PyTorch port's lifetime models and solver grids with
``repro`` (JAX under x64) on shared numpy inputs made from a seed.

Tolerances: pointwise methods rtol 1e-12 (float64 on both sides; only the
last bits of exp/pow differ), icdf rtol 1e-10 (an iterative inversion of
those functions), and the float32 solver grids rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as D
from repro.core.policies.solver_backends import grids as G
from repro_torch.core import carry
from repro_torch.core import distributions as TD
from repro_torch.core.policies.solver_backends import grids as TG

CASES = [
    ("constrained", D.constrained_for("n1-highcpu-16")),
    ("constrained", D.Constrained(tau1=0.6, tau2=0.75, b=24.0, A=0.5)),
    ("diurnal_constrained", D.diurnal_for("n1-highcpu-32", 20.0)),
    ("diurnal_constrained", D.diurnal_for("n1-highcpu-16", 8.0, A=0.44)),
    ("exponential", D.Exponential(mttf=8.0)),
    ("weibull", D.Weibull(lam=0.12, k=0.8)),
]
IDS = [f"{fam}{i}" for i, (fam, _) in enumerate(CASES)]


def _fields(d):
    return {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d)}


def _port(family, d):
    return carry.dist_from_numpy(family, _fields(d), device="cpu")


def _ages(n=257):
    t = np.random.default_rng(0).uniform(0.05, 24.0, n)
    return np.concatenate([t, [0.5, 12.0, 23.99, 24.0]])


@pytest.mark.parametrize("method", ["cdf", "pdf", "hazard"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_pointwise_methods_match_jax(case, method):
    family, d = CASES[case]
    t = _ages()
    with jax.enable_x64(True):
        want = np.asarray(getattr(d, method)(jnp.asarray(t)))
    got = getattr(_port(family, d), method)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_partial_expectation_matches_jax(case):
    family, d = CASES[case]
    b = _ages()
    a = b * np.random.default_rng(1).uniform(0.0, 1.0, b.shape)
    with jax.enable_x64(True):
        want = np.asarray(d.partial_expectation(jnp.asarray(a),
                                                jnp.asarray(b)))
        want0 = np.asarray(d.partial_expectation(jnp.zeros_like(b),
                                                 jnp.asarray(b)))
    port = _port(family, d)
    got = port.partial_expectation(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()
    got0 = port.partial_expectation(torch.zeros(b.shape, dtype=torch.float64),
                                    torch.from_numpy(b)).numpy()
    # a closed form is a difference of two antiderivatives of O(1) size,
    # which cancels where a ~ b: allow their last bits (atol 1e-13)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got0, want0, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_icdf_matches_jax(case):
    family, d = CASES[case]
    with jax.enable_x64(True):
        fl = float(d.cdf(d.L))
        u = np.random.default_rng(2).uniform(0.0, 0.999 * fl, 300)
        want = np.asarray(d.icdf(jnp.asarray(u)))
    got = _port(family, d).icdf(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("grid_dt", [1.0 / 6.0, 1.0 / 12.0])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_cdf_grids_match_jax(case, grid_dt):
    family, d = CASES[case]
    with jax.enable_x64(True):
        Fc, Hc, t_max = G.cdf_grids(d, grid_dt)
        Fc, Hc = np.asarray(Fc), np.asarray(Hc)
    tFc, tHc, t_tmax = TG.cdf_grids(_port(family, d), grid_dt, "cpu")
    assert t_tmax == t_max
    assert tFc.dtype == torch.float32 and tHc.dtype == torch.float32
    np.testing.assert_allclose(tFc.numpy(), Fc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tHc.numpy(), Hc, rtol=1e-6, atol=0)


def test_diurnal_effective_matches_jax():
    d = D.diurnal_for("n1-highcpu-32", 20.0)
    with jax.enable_x64(True):
        want = _fields(d.effective())
    got = _port("diurnal_constrained", d).effective()
    for name, value in want.items():
        np.testing.assert_allclose(float(getattr(got, name)), float(value),
                                   rtol=1e-12)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_dist_from_numpy_round_trip(case):
    family, d = CASES[case]
    port = _port(family, d)
    assert type(port) is TD.registry()[family]
    for name, value in _fields(d).items():
        got = getattr(port, name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert float(got) == float(value)


def test_stacked_fields_carry_and_unstack():
    """JAX's stacked (S,) fields carry across as one stacked port model
    whose per-entry values match each scenario; port stack/unstack invert
    each other."""
    ds = [D.diurnal_for("n1-highcpu-16", c) for c in (8.0, 14.0, 20.0)]
    t = np.array([0.5, 6.0, 23.0])
    with jax.enable_x64(True):
        stacked = D.stack(ds)
        want = np.asarray(stacked.cdf(jnp.asarray(t)))
    port = carry.dist_from_numpy("diurnal_constrained", _fields(stacked),
                                 device="cpu")
    np.testing.assert_allclose(port.cdf(torch.from_numpy(t)).numpy(), want,
                               rtol=1e-12, atol=0)
    singles = [_port("diurnal_constrained", d) for d in ds]
    back = TD.unstack(TD.stack(singles))
    for a, b in zip(singles, back):
        for f in dataclasses.fields(a):
            assert float(getattr(a, f.name)) == float(getattr(b, f.name))
    with pytest.raises(TypeError, match="one distribution family"):
        TD.stack([singles[0], TD.Exponential()])
    with pytest.raises(ValueError, match="leading scenario axis"):
        TD.unstack(singles[0])
