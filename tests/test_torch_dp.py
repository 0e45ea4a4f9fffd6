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


@pytest.mark.parametrize("job,grid_dt", SIZES)
@pytest.mark.parametrize("backend", ["reference", "xla"])
def test_solve_batch_matches_jax(dists, tdists, backend, job, grid_dt):
    with jax.enable_x64(True):
        ref = C.solve_batch(dists, job, grid_dt=grid_dt, restart_overhead=RO,
                            backend=backend)
    got = TC.solve_batch(tdists, job, grid_dt=grid_dt, restart_overhead=RO,
                         device="cpu")
    assert got.backend == "reference" and got.horizon_idx == ref.horizon_idx
    _assert_tables_close(got.V, got.K, ref, 0.999)
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
