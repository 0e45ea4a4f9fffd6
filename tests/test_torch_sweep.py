"""The PyTorch port's scenario sweep against ``repro``'s batched sweep
(JAX under x64), end to end on the CPU at a small size.

With ``repro``'s DP tables carried across, every row matches at rtol 1e-9
(the pools agree to ~1e-15 and the executor is bit-identical on a shared
pool).  With the port's own DP, the expected makespans match at rtol 1e-5,
the DP's float32 tolerance.
"""
import jax
import numpy as np
import pytest

from repro.core import scenarios as SC
from repro_torch.core import carry
from repro_torch.core import scenarios as TSC

KW = dict(seeds=(0, 1), job_steps=60, n_trials=300, grid_dt=1.0 / 12.0)


@pytest.fixture(scope="module")
def jax_sweep():
    with jax.enable_x64(True):
        grid = SC.default_grid()
        tables = SC.ckpt.solve_batch([sc.dist() for sc in grid], 60,
                                     grid_dt=KW["grid_dt"])
        rows = SC.sweep_checkpointing(grid, tables=tables, **KW)
    return tables, rows


def _carried(tables):
    return carry.batch_tables_from_numpy(
        tables.V, tables.K, grid_dt=tables.grid_dt,
        delta_steps=tables.delta_steps,
        restart_overhead=tables.restart_overhead,
        horizon_idx=tables.horizon_idx, device="cpu")


def _assert_rows_match(got, want, rtol, keys=None):
    assert len(got) == len(want) == 48
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in keys or w:
            if isinstance(w[k], float):
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=0,
                                           err_msg=k)
            else:
                assert g[k] == w[k], k


def test_sweep_with_carried_tables_matches_jax(jax_sweep):
    tables, want = jax_sweep
    got = TSC.sweep_checkpointing(TSC.default_grid(), tables=_carried(tables),
                                  device="cpu", **KW)
    _assert_rows_match(got, want, rtol=1e-9)
    assert all(r["unfinished_frac"] == 0.0 for r in got)


def test_sweep_with_own_dp_matches_jax(jax_sweep):
    _, want = jax_sweep
    got = TSC.sweep_checkpointing(TSC.default_grid(), device="cpu", **KW)
    _assert_rows_match(got, want, rtol=1e-5,
                       keys=("scenario", "policy", "seed", "p_fail_fresh",
                             "expected_makespan_dp"))
    for r in got:
        assert np.isfinite(r["makespan_mean"])
        if r["policy"] == "dp":
            assert abs(r["makespan_mean"] - r["expected_makespan_dp"]) \
                < 0.05 * r["expected_makespan_dp"]


def test_sweep_rejects_mismatched_tables(jax_sweep):
    tables, _ = jax_sweep
    carried = _carried(tables)
    grid = TSC.default_grid()
    with pytest.raises(ValueError, match="this sweep needs"):
        TSC.sweep_checkpointing(grid[:4], tables=carried, device="cpu", **KW)
    with pytest.raises(ValueError, match="different"):
        TSC.sweep_checkpointing(grid, tables=carried, device="cpu",
                                **{**KW, "grid_dt": 1.0 / 6.0,
                                   "job_steps": 60})
    with pytest.raises(ValueError, match="unknown checkpointing policy"):
        TSC.sweep_checkpointing(grid, tables=carried, device="cpu",
                                policies=("dp", "oracle"), **KW)


def test_registry_and_default_grid():
    grid = TSC.default_grid()
    assert len(grid) == 8 and TSC.default_grid()[0] is grid[0]
    assert [sc.name for sc in grid] == [sc.name for sc in SC.default_grid()]
    assert set(sc.name for sc in grid) <= set(TSC.names())
    assert TSC.get(grid[3].name) is grid[3]
    with pytest.raises(ValueError, match="already registered"):
        TSC.register(grid[0])
    assert TSC.register(grid[0], overwrite=True) is grid[0]
    d = TSC.Scenario(name="x", zone="us-central1-a", phase="day").dist()
    assert d.launch_clock == 20.0
    assert d.A == pytest.approx(0.475 * 1.08)
