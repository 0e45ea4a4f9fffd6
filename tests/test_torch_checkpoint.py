"""The port's checkpoint IO and DP-scheduled ``CheckpointManager`` on the
CPU, against ``repro.checkpoint``.

IO mirrors ``tests/test_checkpoint.py``: a round trip is bit-identical,
the newest intact checkpoint wins, a torn write is skipped, an async write
lands, an emergency save blocks and is counted.  The schedule is held to
``repro``'s manager: for each policy, the same walk (500 steps of 0.01 h,
two preemptions with an emergency save and a restart) must checkpoint at
the same steps.  The DP tables come from the port's plain recurrence and
from ``repro``'s reference solver on the same float32 grids; at this size
(J = 300, T = 1441) 0.33 % of K differ, and every one is a tie: the two
choices, re-evaluated in float64 on ``repro``'s V with the restart cost
of its previous sweep (as the recurrence reads it), cost the same within
1e-6 relative (the worst is 3.2e-7), the rule ``tests/test_torch_dp.py``
applies.  One such tie falls on a plan of the dp walk (a checkpoint at
step 240 against 242), so the dp schedules are held equal up to the
first plan that reads a tied K.  The module runs on one intra-op thread:
its DP solves are thousands of small operations, which parallel test
workers otherwise slow down by oversubscribing the cores.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import distributions as JD
from repro.core.policies import checkpointing as JC
from repro.core.policies.solver_backends import grids as JG
from repro_torch.checkpoint import (CheckpointManager, restore_latest,
                                    save_checkpoint)
from repro_torch.core import distributions as TD
from repro_torch.optim import AdamWState



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operations: one intra-op thread, so that test workers
    sharing the cores do not oversubscribe them (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"a": torch.randn((4, 8), generator=g),
                       "nested": [torch.arange(6, dtype=torch.int32)
                                  .reshape(2, 3), torch.ones(3)]},
            "opt": AdamWState(step=torch.tensor(7, dtype=torch.int32),
                              mu={"a": torch.randn(5, generator=g)},
                              nu={"a": torch.rand(5, generator=g)})}


def _flat(tree):
    out = []
    if isinstance(tree, dict):
        for v in tree.values():
            out += _flat(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out += _flat(v)
    else:
        out.append(tree)
    return out


def test_roundtrip_is_bit_identical(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree, {"note": "x"})
    restored, step, meta = restore_latest(str(tmp_path), _tree(1))
    assert step == 7 and meta["note"] == "x"
    assert isinstance(restored["opt"], AdamWState)
    for a, b in zip(_flat(tree), _flat(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_follows_the_template_and_checks_shapes(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    template = _tree()
    template["params"]["a"] = torch.zeros((4, 8), dtype=torch.float64)
    restored, _, _ = restore_latest(str(tmp_path), template)
    assert restored["params"]["a"].dtype == torch.float64
    template["params"]["a"] = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="params/a"):
        restore_latest(str(tmp_path), template)


def test_latest_wins_and_torn_write_skipped(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 10, _tree(1))
    save_checkpoint(d, 20, _tree(2))
    assert restore_latest(d, _tree())[1] == 20
    # corrupt the newest (a preemption mid-write)
    with open(os.path.join(d, "step_0000000020", "arrays.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 64)
    restored, step, _ = restore_latest(d, _tree())
    assert step == 10, "a corrupted checkpoint must be skipped"
    for a, b in zip(_flat(_tree(1)), _flat(restored)):
        assert torch.equal(a, b)


def test_async_write(tmp_path):
    th = save_checkpoint(str(tmp_path), 3, _tree(), blocking=False)
    th.join(timeout=60)
    assert not th.is_alive()
    assert restore_latest(str(tmp_path), _tree())[1] == 3


STEPS = 500          # 5 h of 0.01 h steps: a DP of J = 300


def _mgr(tmp_path, policy, **kw):
    return CheckpointManager(directory=str(tmp_path), dist=TD.constrained_for(),
                             policy=policy, step_time_hours=0.01,
                             total_steps=STEPS, async_write=False,
                             device="cpu", **kw)


def test_emergency_save_is_blocking_and_counted(tmp_path):
    mgr = CheckpointManager(directory=str(tmp_path),
                            dist=TD.constrained_for(), policy="none",
                            async_write=True, device="cpu")
    mgr.on_preemption_warning(42, _tree())
    assert mgr.n_emergency == 1 and mgr.n_saved == 1
    assert not mgr._writer.is_alive()
    assert restore_latest(str(tmp_path), _tree())[1] == 42


def test_policy_none(tmp_path):
    assert not _mgr(tmp_path, "none").should_checkpoint(10 ** 6)


def _walk(mgr, tree, preempt_at=(150, 325)):
    """Steps 1..total: save when due; at each ``preempt_at`` step an
    emergency save and a restart from it.  Returns the saved steps."""
    saved = []
    for step in range(1, mgr.total_steps + 1):
        if mgr.should_checkpoint(step):
            mgr.save(step, tree)
            saved.append(step)
        if step in preempt_at:
            mgr.on_preemption_warning(step, tree)
            saved.append(("emergency", step))
            mgr.on_restart(pod_age_hours=0.0, resumed_step=step)
    return saved


def _cost(F, H, V, R, j, t, i, dt, t_max, delta):
    """Float64 makespan cost of candidate interval ``i`` at (j, t), with
    restart cost ``R[j]`` (the manager solves with no restart overhead)."""
    w = np.where(i == j, i, i + delta)
    end = np.minimum(t + w, t_max)
    Ft, Fe = F[t], F[end]
    p_fail = np.clip((Fe - Ft) / np.maximum(1.0 - Ft, JG._EPS), 0.0, 1.0)
    dF = np.maximum(Fe - Ft, JG._EPS)
    e_lost = np.clip((H[end] - H[t]) / dF - t * dt, 0.0, w * dt)
    return (1.0 - p_fail) * (w * dt + V[j - i, end]) \
        + p_fail * (e_lost + R[j])


def _flips_are_ties(tm, jm):
    """Every K of the port's table that differs from repro's costs the
    same as repro's choice within 1e-6 relative (float64, repro's V, the
    restart cost of its previous sweep).  Returns the (j, t) of the
    flips."""
    K, Kr = tm._tables.K.numpy(), np.asarray(jm._tables.K)
    assert (K == Kr).mean() >= 0.99
    j_max = K.shape[0] - 1
    with jax.enable_x64(True):
        Fc, Hc, t_max = JG.cdf_grids(jm.dist, jm.grid_dt)
        prev = JC.solve(jm.dist, j_max, grid_dt=jm.grid_dt, delta_steps=1,
                        n_sweeps=2)
    F, H = np.asarray(Fc, np.float64), np.asarray(Hc, np.float64)
    V = np.asarray(jm._tables.V, np.float64)
    R = np.asarray(prev.V, np.float64)[:, 0]
    j, t = np.nonzero(K != Kr)
    a = _cost(F, H, V, R, j, t, K[j, t], jm.grid_dt, t_max, 1)
    b = _cost(F, H, V, R, j, t, Kr[j, t], jm.grid_dt, t_max, 1)
    assert np.all(np.abs(a - b) <= 1e-6 * b)
    return set(zip(j.tolist(), t.tolist()))


def _plans(mgr, saved):
    """The (remaining grid steps, age index) K entry each save planned
    from, replayed from the saved steps (the walk's restarts re-anchor
    the pod's start at the emergency steps)."""
    out, start = [], 0
    for s in saved:
        step = s[1] if isinstance(s, tuple) else s
        if isinstance(s, tuple):
            start = step
        rem = max(int(round((mgr.total_steps - step) * mgr.step_time_hours
                            / mgr.grid_dt)), 1)
        age = int(round((step - start) * mgr.step_time_hours / mgr.grid_dt))
        out.append((min(rem, mgr._tables.V.shape[0] - 1), age))
    return out


@pytest.mark.parametrize("policy", ["dp", "young_daly", "fixed", "none"])
def test_schedule_matches_repro(tmp_path, policy):
    # repro's grids in float64 before the float32 solve, as the port
    # computes them (tests/test_torch_dp.py runs repro the same way)
    with jax.enable_x64(True):
        jm = JManager(directory=str(tmp_path / "jax"),
                      dist=JD.constrained_for(), policy=policy,
                      step_time_hours=0.01, total_steps=STEPS,
                      async_write=False)
        want = _walk(jm, {"x": jnp.zeros(1)})
    tm = _mgr(tmp_path / "port", policy)
    got = _walk(tm, {"x": torch.zeros(1)})
    assert (tm.n_emergency, jm.n_emergency) == (2, 2)
    if policy != "dp":
        assert got == want
        assert tm.n_saved == jm.n_saved
        return
    ties = _flips_are_ties(tm, jm)
    # equal up to the first plan that read a tied K, and that plan's K is
    # one of the ties
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    assert got[:n] == want[:n]
    if n < min(len(got), len(want)):
        assert _plans(tm, got[:n])[-1] in ties
    # the schedule is non-uniform: gaps lengthen as the hazard decays
    gaps = np.diff([s for s in got[:4] if isinstance(s, int)])
    assert gaps[-1] > gaps[0]


def test_dp_schedule_solves_on_the_managers_device(tmp_path):
    mgr = _mgr(tmp_path, "dp")
    assert mgr._tables.K.device == torch.device("cpu")
    before = mgr._next_ckpt_step
    mgr.on_restart(pod_age_hours=0.0, resumed_step=250)
    after = mgr._next_ckpt_step
    assert after > 250, "the schedule must re-anchor at the resumed step"
    assert after - 250 <= before * 2 + 1


def test_young_daly_schedule_uniform(tmp_path):
    mgr = _mgr(tmp_path, "young_daly")
    g1 = mgr._next_ckpt_step
    mgr.save(g1, _tree())
    assert mgr._next_ckpt_step - g1 == g1, "Young-Daly is periodic"
