"""Parity of the PyTorch port's batch service (reuse tables, the serial
heap loop, the batched loop and ``sweep_service``) with ``repro`` (JAX
under x64), on the CPU at small sizes: bags of 12-40 jobs, clusters of
2-8 VMs, 2-3 seeds.

Tolerances:
- ``ReuseTables`` / ``ReuseTable.decide``: booleans equal.
- ``draw_service_pool[_batch]``: rtol 1e-10 (the engine's pool contract:
  the same numpy uniforms inverted in float64 on both sides).
- ``simulate_service_batch`` and the serial ``BatchService.run`` on a
  SHARED pool and table: every field bit-identical, NaN positions
  included; the port's serial loop and the port's batched lanes likewise.
- ``run_bag_grid`` / ``sweep_service`` with each side drawing its own pools
  and tables: equal keys and counts, floats within rtol 1e-9.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import distributions as D
from repro.core import engine as E
from repro.core import scenarios as SC
from repro.core import service as S
from repro.core import service_kernel as K
from repro_torch.core import carry
from repro_torch.core import distributions as TD
from repro_torch.core import engine as TE
from repro_torch.core import scenarios as TSC
from repro_torch.core import service as TS
from repro_torch.core import service_kernel as TK

J, P = 30, 400
DISTS = [("diurnal_constrained", D.diurnal_for("n1-highcpu-32", 20.0)),
         ("diurnal_constrained", D.diurnal_for("n1-highcpu-16", 8.0)),
         ("diurnal_constrained", D.diurnal_for("n1-highcpu-16", 14.0,
                                               A=0.44))]


def _port(family, d):
    return carry.dist_from_numpy(
        family, {f.name: np.asarray(getattr(d, f.name))
                 for f in dataclasses.fields(d)}, device="cpu")


def _jax_dists():
    return [d for _, d in DISTS]


def _port_dists():
    return [_port(f, d) for f, d in DISTS]


@pytest.fixture(scope="module")
def shared():
    """Pools, bags and reuse tables drawn once by ``repro`` under x64: the
    shared inputs both batched loops are fed."""
    with jax.enable_x64(True):
        pools = K.draw_service_pool_batch(_jax_dists(), [0, 1, 2], size=P)
        lengths = np.stack([S._bag_lengths(J, 2.0, 0.1, s) for s in (0, 1)])
        vals = S.grid_reuse_values(_jax_dists()[0], seeds=(0, 1), n_jobs=J,
                                   job_hours=2.0, jitter=0.1,
                                   checkpointing=True)
        tabs = E.ReuseTables(_jax_dists(), vals)
    return dict(pools=pools, lengths=lengths, tabs=tabs, values=vals)


def _assert_batch_identical(got, want):
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            assert np.array_equal(g, w, equal_nan=True), f.name
        else:
            assert g == w, f.name


def _assert_result_identical(got, want, jobs=True):
    """Two ServiceResults equal to the bit (per-job records included)."""
    for f in dataclasses.fields(want):
        if f.name == "jobs":
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if jobs:
        assert len(got.jobs) == len(want.jobs)
        for gj, wj in zip(got.jobs, want.jobs):
            for k in ("finished", "attempts", "failures", "done_work"):
                assert getattr(gj, k) == getattr(wj, k), k


# ---------------------------------------------------------------------------
# reuse tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("checkpointing", [False, True])
def test_reuse_tables_match_jax(checkpointing):
    grid = SC.default_grid()
    with jax.enable_x64(True):
        dl = [sc.dist() for sc in grid]
        vals = S.grid_reuse_values(dl[0], seeds=(0, 1, 2), n_jobs=40,
                                   job_hours=2.0, jitter=0.1,
                                   checkpointing=checkpointing)
        want = E.ReuseTables(dl, vals)
        single = E.ReuseTable(dl[3], vals)
    got = TE.ReuseTables([sc.dist() for sc in TSC.default_grid()], vals,
                         device="cpu")
    assert got.tables.shape == want.tables.shape == (8, len(want.T_values),
                                                     1441)
    assert np.array_equal(got.tables, want.tables)
    assert np.array_equal(got.tensor.numpy(), want.tables)
    assert np.array_equal(got.T_values, want.T_values) and got.L == want.L
    one = TE.ReuseTable(TSC.default_grid()[3].dist(), vals, device="cpu")
    assert np.array_equal(one.table, single.table)
    # decide(): the same index arithmetic on probes between, at and beyond
    # the grid points
    rng = np.random.default_rng(0)
    rems = np.concatenate([vals[:5], rng.uniform(0.0, 2.5, 40), [9.0]])
    ages = np.concatenate([[0.0, 1 / 120, 12.0, 23.99, 30.0],
                           rng.uniform(0.0, 24.0, 20)])
    for s in (0, 5):
        jv, tv = want.view(s), got.view(s)
        assert all(tv.decide(r, a) == jv.decide(r, a)
                   for r in rems for a in ages)


def test_reuse_tables_reject_different_deadlines():
    a = TD.constrained_for("n1-highcpu-16")
    b = dataclasses.replace(a, L=20.0)
    with pytest.raises(ValueError, match="shared L"):
        TE.ReuseTables([a, b], [1.0, 2.0], device="cpu")


# ---------------------------------------------------------------------------
# lifetime pools
# ---------------------------------------------------------------------------

def test_service_pools_match_jax():
    with jax.enable_x64(True):
        want = K.draw_service_pool_batch(_jax_dists(), [0, 3, 0], size=512)
        want_one = S.draw_service_pool(_jax_dists()[1], seed=3, size=512)
    got = TK.draw_service_pool_batch(_port_dists(), [0, 3, 0], size=512,
                                     device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == (3, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)
    one = TS.draw_service_pool(_port_dists()[1], seed=3, size=512,
                               device="cpu")
    np.testing.assert_allclose(one, want_one, rtol=1e-10, atol=0)
    # a caller's rng is advanced, as the sampler's refills need
    rng = np.random.default_rng(3)
    TS.draw_service_pool(_port_dists()[1], rng=rng, size=100, device="cpu")
    assert rng.uniform() == np.random.default_rng(3).uniform(size=101)[-1]


# ---------------------------------------------------------------------------
# the batched loop on shared inputs
# ---------------------------------------------------------------------------

def _mixed_lanes(shared, **over):
    """16 mixed lanes: both policies, with and without deflation, three
    pools and tables, clusters 2-8 below max_slots 8."""
    tabs = shared["tabs"]
    B = 16
    kw = dict(lengths=shared["lengths"], pools=shared["pools"],
              bag_index=[0, 1] * 8, pool_index=[0, 1, 2, 1] * 4,
              policy=["model", "memoryless"] * 8,
              cluster_size=[8, 4, 5, 8, 3, 6, 8, 2] * 2,
              tables=tabs.tables, T_values=tabs.T_values, reuse_L=tabs.L,
              table_index=[0, 1, 2, 1] * 4,
              deflate=[False] * 8 + [True] * 8, deflate_factor=0.5,
              max_slots=8)
    kw.update(over)
    assert len(kw["policy"]) == B
    return kw


CONFIGS = {
    "plain": dict(),
    "checkpointing+deadlines": dict(
        checkpointing=True,
        deadlines=np.where(np.arange(J) % 3 == 0, 3.0, np.inf)[None].repeat(
            2, 0)),
    "priced+checkpointing": dict(
        checkpointing=True, ckpt_interval=0.25, ckpt_cost=0.05,
        price_rows=np.random.default_rng(3).uniform(0.5, 2.0, (16, 40)),
        price_dt=0.25, deflate_factor=np.linspace(0.3, 1.0, 16)),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_batched_loop_bit_identical_to_jax(shared, config):
    kw = _mixed_lanes(shared, **CONFIGS[config])
    with jax.enable_x64(True):
        want = K.simulate_service_batch(**kw)
    got = TK.simulate_service_batch(**kw, device="cpu")
    _assert_batch_identical(got, want)
    assert not got.truncated.any() and not got.deadlocked.any()
    assert np.all(~np.isnan(got.finished_time) | got.rejected)
    if config == "checkpointing+deadlines":
        assert got.n_rejected.min() > 0 and got.rejected.any()
    if config.startswith("priced"):
        assert got.priced and not np.array_equal(got.dollars, got.vm_hours)
    # the device tables may come as the ReuseTables tensor itself
    if config == "plain":
        again = TK.simulate_service_batch(
            **dict(kw, tables=torch.tensor(kw["tables"])), device="cpu")
        _assert_batch_identical(again, want)


def test_batched_loop_with_reuse_denials_bit_identical_to_jax(shared):
    """Jobs of ~6 h on 4-6 VMs: the model policy now denies reuse of
    spares whose window would run too late, so its lanes leave their
    memoryless twins (same bag, pool and cluster); both stay bit-identical
    to ``repro``'s."""
    lengths = np.stack([S._bag_lengths(J, 6.0, 0.1, s) for s in (0, 1)])
    with jax.enable_x64(True):
        vals = S.grid_reuse_values(_jax_dists()[0], seeds=(0, 1), n_jobs=J,
                                   job_hours=6.0, jitter=0.1)
        tabs = E.ReuseTables(_jax_dists(), vals)
    kw = dict(lengths=lengths, pools=shared["pools"],
              bag_index=[0, 1, 0, 1] * 4, pool_index=[0, 1, 2, 0] * 4,
              policy=["model"] * 8 + ["memoryless"] * 8,
              cluster_size=[6, 4] * 8, tables=tabs.tables,
              T_values=tabs.T_values, reuse_L=tabs.L,
              table_index=[0, 1, 2, 0] * 4,
              deflate=([False] * 4 + [True] * 4) * 2)
    with jax.enable_x64(True):
        want = K.simulate_service_batch(**kw)
    got = TK.simulate_service_batch(**kw, device="cpu")
    _assert_batch_identical(got, want)
    assert np.all(got.makespan[:8] != got.makespan[8:])


def test_exhausted_pool_flags_like_jax(shared):
    kw = _mixed_lanes(shared, pools=shared["pools"][:, :12])
    with jax.enable_x64(True):
        want = K.simulate_service_batch(**kw, on_exhausted="flag")
    got = TK.simulate_service_batch(**kw, on_exhausted="flag", device="cpu")
    assert got.pool_exhausted.any()
    _assert_batch_identical(got, want)
    with pytest.raises(RuntimeError, match="pool exhausted"):
        TK.simulate_service_batch(**kw, device="cpu")
    with pytest.raises(RuntimeError, match="max_steps"):
        TK.simulate_service_batch(**_mixed_lanes(shared), max_steps=20,
                                  device="cpu")


def test_batched_loop_validates_its_inputs(shared):
    kw = _mixed_lanes(shared)
    bad = [dict(bag_index=[5] * 16), dict(pool_index=[-1] * 16),
           dict(cluster_size=[0] * 16), dict(table_index=[3] * 16),
           dict(max_slots=4), dict(tables=None),
           dict(deflate_factor=1.5), dict(price_rows=-np.ones(4)),
           dict(on_exhausted="ignore")]
    for over in bad:
        with pytest.raises(ValueError):
            TK.simulate_service_batch(**dict(kw, **over), device="cpu")
    with pytest.raises(ValueError, match="unknown service policy"):
        TK.split_policy("model+spot")
    assert TK.split_policy("memoryless+deflate") == ("memoryless", True)


# ---------------------------------------------------------------------------
# the serial heap loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,checkpointing,priced", [
    ("model", False, False), ("memoryless", True, False),
    ("model", True, True)])
def test_serial_loop_bit_identical_to_jax(shared, policy, checkpointing,
                                          priced):
    """One shared pool and table: the port's heap loop replays ``repro``'s
    event for event."""
    pool, tab = shared["pools"][0], shared["tabs"]
    kw = dict(vm_type="n1-highcpu-32", cluster_size=6, policy=policy,
              seed=0, checkpointing=checkpointing, lifetime_pool=pool,
              pool_size=P)
    if priced:
        kw.update(price_trace=np.random.default_rng(1).uniform(0.5, 2, 30),
                  price_dt=0.5)
    with jax.enable_x64(True):
        want = S.BatchService(_jax_dists()[0], reuse_table=tab.view(0),
                              **kw).run(shared["lengths"][0])
    table = TE.ReuseTable(_port_dists()[0], tab.T_values,
                          _table=torch.tensor(tab.tables[0]))
    got = TS.BatchService(_port_dists()[0], reuse_table=table, device="cpu",
                          **kw).run(shared["lengths"][0])
    _assert_result_identical(got, want)
    assert got.n_preemptions > 0


def test_serial_loop_without_table_matches_jax():
    """``vectorized_reuse=False`` asks the port's ``reuse_decision`` per
    candidate; the pool is shared, so the runs agree to the bit."""
    lengths = S._bag_lengths(12, 2.0, 0.1, 4)
    with jax.enable_x64(True):
        pool = S.draw_service_pool(_jax_dists()[1], seed=4, size=256)
        want = S.BatchService(_jax_dists()[1], cluster_size=4, seed=4,
                              vectorized_reuse=False, lifetime_pool=pool,
                              pool_size=256).run(lengths)
    got = TS.BatchService(_port_dists()[1], cluster_size=4, seed=4,
                          vectorized_reuse=False, lifetime_pool=pool,
                          pool_size=256, device="cpu").run(lengths)
    _assert_result_identical(got, want)


def test_serial_sampler_refills_like_jax():
    """A pool of 8 lifetimes runs out: the refills draw from the stream
    past the external pool's uniforms, as ``repro``'s sampler does."""
    lengths = S._bag_lengths(16, 2.0, 0.1, 2)
    kw = dict(cluster_size=4, seed=2, policy="memoryless", pool_size=8)
    with jax.enable_x64(True):
        pool = S.draw_service_pool(_jax_dists()[0], seed=2, size=8)
        want = S.BatchService(_jax_dists()[0], lifetime_pool=pool,
                              **kw).run(lengths)
    got = TS.BatchService(_port_dists()[0], lifetime_pool=pool,
                          device="cpu", **kw).run(lengths)
    # the refills are the port's own draws (rtol 1e-10 from repro's)
    assert got.n_preemptions == want.n_preemptions
    np.testing.assert_allclose(got.makespan, want.makespan, rtol=1e-9)
    np.testing.assert_allclose(got.vm_hours, want.vm_hours, rtol=1e-9)


def test_serial_and_batched_port_lanes_bit_identical():
    """``run_bag_grid`` in both modes draws the same pools and tables, so
    the port's heap loop and its batched lanes agree to the bit, per job
    too."""
    kw = dict(vm_types=("n1-highcpu-16", "n1-highcpu-32"),
              policies=("model", "memoryless"), cluster_sizes=(4, 8),
              seeds=(0, 1), n_jobs=20, pool_size=P, checkpointing=True,
              dist_for=TD.constrained_for, device="cpu")
    serial = TS.run_bag_grid(mode="serial", **kw)
    batched = TS.run_bag_grid(mode="batched", **kw)
    assert len(serial) == len(batched) == 16
    for s, b in zip(serial, batched):
        assert {k: s[k] for k in s if k != "result"} == \
            {k: b[k] for k in b if k != "result"}
        _assert_result_identical(b["result"], s["result"])


def _close_results(got, want, rtol=1e-9):
    for f in dataclasses.fields(want):
        if f.name == "jobs":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, float):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                       err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("mode", ["serial", "batched"])
def test_run_bag_grid_matches_jax(mode):
    kw = dict(vm_types=("n1-highcpu-16", "n1-highcpu-32"),
              policies=("model", "memoryless"), cluster_sizes=(6,),
              seeds=(0, 1), n_jobs=16, pool_size=P)
    with jax.enable_x64(True):
        want = S.run_bag_grid(mode=mode, **kw)
    got = TS.run_bag_grid(mode=mode, device="cpu", **kw)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert [g[k] for k in ("vm_type", "policy", "cluster_size",
                               "seed")] == \
            [w[k] for k in ("vm_type", "policy", "cluster_size", "seed")]
        _close_results(g["result"], w["result"])


def test_run_bag_matches_jax():
    with jax.enable_x64(True):
        want = S.run_bag(_jax_dists()[2], n_jobs=12, cluster_size=4,
                         seed=5, pool_size=64)
    got = TS.run_bag(_port_dists()[2], n_jobs=12, cluster_size=4, seed=5,
                     pool_size=64, device="cpu")
    _close_results(got, want)


def test_serial_grid_rejects_batched_only_options():
    with pytest.raises(ValueError, match="mode='batched'"):
        TS.run_bag_grid(deadline_hours=6.0, device="cpu")
    with pytest.raises(ValueError, match="mode='batched'"):
        TS.run_bag_grid(policies=("model+deflate",), device="cpu")
    with pytest.raises(ValueError, match="mode='batched'"):
        TSC.sweep_service(TSC.default_grid()[:1], deadline_hours=6.0,
                          device="cpu")


# ---------------------------------------------------------------------------
# sweep_service
# ---------------------------------------------------------------------------

SWEEP = dict(cluster_sizes=(8,), seeds=(0, 1), n_jobs=24, pool_size=P)


@pytest.mark.parametrize("mode,extra", [
    ("serial", dict(policies=("model", "memoryless"))),
    ("batched", dict(policies=("model", "memoryless", "model+deflate",
                               "memoryless+deflate"))),
    ("batched", dict(policies=("model", "memoryless"), deadline_hours=2.2,
                     checkpointing=True))])
def test_sweep_service_matches_jax(mode, extra):
    with jax.enable_x64(True):
        want = SC.sweep_service(SC.default_grid()[:3], mode=mode, **SWEEP,
                                **extra)
    got = TSC.sweep_service(TSC.default_grid()[:3], mode=mode, device="cpu",
                            **SWEEP, **extra)
    assert len(got) == len(want) == 3 * len(extra["policies"]) * 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=1e-9, atol=0,
                                           err_msg=k)
            else:
                assert g[k] == v, k
    if "deadline_hours" in extra:
        assert sum(r["n_rejected"] for r in got) > 0
