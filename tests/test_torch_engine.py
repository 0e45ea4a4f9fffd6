"""Parity of the PyTorch port's lifetime pools and makespan executor with
``repro.core.engine`` (JAX under x64), on the CPU.

Executor contract: on one shared pool the float64 makespans and the
completion masks are bit-identical (NaN positions included) - the loop
counts work in integer grid steps and its only float accumulation is the
same sequence of additions.  Pool contract: the same numpy uniforms in the
same order, inverted in float64 on both sides, agree to rtol 1e-10.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import distributions as D
from repro.core import engine as E
from repro.core.policies import checkpointing as C
from repro_torch.core import carry
from repro_torch.core import engine as TE

JOB, GRID, N, MAXR = 60, 1.0 / 12.0, 300, 64


def _port(family, d):
    fields = {f.name: np.asarray(getattr(d, f.name))
              for f in dataclasses.fields(d)}
    return carry.dist_from_numpy(family, fields, device="cpu")


@pytest.fixture(scope="module")
def cells():
    return [("diurnal_constrained", D.diurnal_for("n1-highcpu-32", 20.0)),
            ("diurnal_constrained", D.diurnal_for("n1-highcpu-16", 8.0)),
            ("constrained", D.constrained_for("n1-highcpu-16"))]


@pytest.fixture(scope="module")
def pools(cells):
    """JAX pools drawn once under x64: (first, pool) of shape (3, N) and
    (3, N, MAXR + 2), per-entry seeds 0, 1, 0."""
    with jax.enable_x64(True):
        return E.draw_lifetime_pool_batch([d for _, d in cells], N,
                                          max_restarts=MAXR, seed=[0, 1, 0])


@pytest.fixture(scope="module")
def tables(cells):
    with jax.enable_x64(True):
        dp = C.solve_batch([d for _, d in cells], JOB, grid_dt=GRID)
    return np.asarray(dp.K)


@pytest.mark.parametrize("seed,start_age", [([0, 1, 0], 0.0), (3, 0.0),
                                            ([2, 2, 5], 1.5)])
def test_pool_draw_matches_jax(cells, seed, start_age):
    with jax.enable_x64(True):
        want_first, want_pool = E.draw_lifetime_pool_batch(
            [d for _, d in cells], N, max_restarts=MAXR, seed=seed,
            start_age=start_age)
    first, pool = TE.draw_lifetime_pool_batch(
        [_port(f, d) for f, d in cells], N, max_restarts=MAXR, seed=seed,
        start_age=start_age, device="cpu")
    assert first.dtype == torch.float64 and tuple(pool.shape) == \
        want_pool.shape
    np.testing.assert_allclose(first.numpy(), want_first, rtol=1e-10, atol=0)
    np.testing.assert_allclose(pool.numpy(), want_pool, rtol=1e-10, atol=0)


def test_pool_draw_rejects_seed_count(cells):
    with pytest.raises(ValueError, match="one seed per entry"):
        TE.draw_lifetime_pool_batch([_port(f, d) for f, d in cells], 4,
                                    seed=[0, 1], device="cpu")


def _both(table, first, pool, **kw):
    """(jax, port) results of simulate_makespan_batch on the same inputs."""
    kw = dict(dict(grid_dt=GRID, delta_steps=1, max_restarts=MAXR,
                   return_finished=True), **kw)
    with jax.enable_x64(True):
        want = E.simulate_makespan_batch(table, JOB, first=first, pool=pool,
                                         **kw)
    got = TE.simulate_makespan_batch(table, JOB, first=first, pool=pool,
                                     device="cpu", **kw)
    return want, got


def _assert_identical(want, got):
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w, equal_nan=True)


def test_executor_single_table_bit_identical(pools, tables):
    first, pool = pools
    for table in (tables[0], E.young_daly_policy_table(7, JOB),
                  E.no_checkpoint_policy_table(JOB)):
        _assert_identical(*_both(table, first[0], pool[0]))


def test_executor_cell_batched_bit_identical(pools, tables):
    first, pool = pools
    _assert_identical(*_both(tables, first, pool))            # per-cell
    _assert_identical(*_both(tables[1], first, pool))         # shared 2-D


def test_executor_indexed_fold_bit_identical(pools, tables):
    first, pool = pools
    table_u = E.stack_policy_tables(
        [tables[0], tables[2], E.young_daly_policy_table(9, JOB),
         E.no_checkpoint_policy_table(JOB)], t_axis=tables.shape[2])
    port_u = TE.stack_policy_tables(
        [torch.from_numpy(tables[0].copy()), tables[2],
         TE.young_daly_policy_table(9, JOB),
         TE.no_checkpoint_policy_table(JOB)], t_axis=tables.shape[2],
        device="cpu")
    assert np.array_equal(port_u.numpy(), table_u)
    tix = np.array([0, 1, 2, 3, 2, 0, 1])
    pix = np.array([0, 2, 1, 1, 0, 2, 0])
    _assert_identical(*_both(table_u, first[pix], pool, table_index=tix,
                             pool_index=pix))


@pytest.mark.parametrize("unfinished", ["nan", "partial"])
def test_executor_unfinished_trials_bit_identical(pools, tables, unfinished):
    """max_restarts = 2 leaves trials unfinished; NaN positions and the
    partial sums match."""
    first, pool = pools
    want, got = _both(tables, first, pool[:, :, :4], max_restarts=2,
                      unfinished=unfinished)
    assert not want[1].all()
    _assert_identical(want, got)


def test_executor_start_age_and_overhead_bit_identical(pools, tables):
    first, pool = pools
    _assert_identical(*_both(tables[2], first[2], pool[2], start_age=0.4,
                             restart_overhead=0.25))


def test_executor_argument_errors(pools, tables):
    first, pool = pools
    kw = dict(first=first, pool=pool, device="cpu")
    with pytest.raises(ValueError, match="unfinished must be"):
        TE.simulate_makespan_batch(tables, JOB, unfinished="drop", **kw)
    with pytest.raises(ValueError, match="passed together"):
        TE.simulate_makespan_batch(tables, JOB, table_index=[0, 1, 2], **kw)
    with pytest.raises(ValueError, match="out of range"):
        TE.simulate_makespan_batch(tables, JOB, table_index=[0, 1, 3],
                                   pool_index=[0, 1, 2], **kw)
    with pytest.raises(ValueError, match="scenario-batched pool"):
        TE.simulate_makespan_batch(tables, JOB, first=first[0], pool=pool[0],
                                   device="cpu")
    with pytest.raises(RuntimeError, match="unfinished"):
        TE.simulate_makespan_batch(tables, JOB, first=first,
                                   pool=pool[:, :, :4], max_restarts=2,
                                   unfinished="raise", device="cpu")


def test_policy_table_helpers_match_jax(tables):
    for fn, args in ((E.young_daly_policy_table, (7, JOB)),
                     (E.no_checkpoint_policy_table, (JOB,))):
        want = fn(*args)
        got = getattr(TE, fn.__name__)(*args)
        assert np.array_equal(got, want) and got.dtype == want.dtype
    k0 = torch.from_numpy(tables[0].copy())
    assert np.array_equal(TE.validate_policy_table(k0),
                          E.validate_policy_table(tables[0]))
    bad = tables[0].copy()
    bad[5, 3] = 6
    for fn in (E.validate_policy_table, TE.validate_policy_table):
        with pytest.raises(ValueError, match="outside"):
            fn(bad)
    with pytest.raises(ValueError, match="resampling"):
        TE.stack_policy_tables([tables[0], tables[1][:, :5]], device="cpu")
