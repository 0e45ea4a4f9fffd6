"""Scenario-sharded DP solves and data-parallel training over
``torch.distributed``, on the CPU in ``gloo`` processes.

``repro``'s own sharded tests (``test_sharding.py``,
``test_elastic.py``) fail on JAX 0.9, so they are no oracle.  The port's
multi-process paths are held instead to its one-process paths on the same
inputs, which the other ``test_torch_*`` files hold to ``repro``:

- ``shard_scenarios`` returns the function it was given, the same object,
  with no active group, a 1-rank group, or a world size that does not
  divide S; the tables are then the one-process ones.
- Under W = 4 every rank's ``BatchDPTables`` equal the one-process solve
  bit for bit (8 default-grid scenarios at J = 60, dt = 1/12): both
  backends, both objectives, with and without a warm start, and
  ``refine=True`` with ``refine_check`` "col0" and "full".  One case is
  also held to ``repro``'s unsharded ``solve_batch`` under x64 at the DP
  contract of ``docs/solver.md`` (allclose 1e-5, >= 99.5 % argmin
  agreement).
- Data-parallel train steps: W = 2 equals one process with
  ``grad_accum = 2`` bit for bit; W = 4 is held to ``grad_accum = 1`` at
  ``test_torch_train.py::test_train_step_grad_accum_equivalence``'s
  tolerances (loss rtol 1e-5, parameters atol 2e-5); every rank holds the
  same parameters; a MoE arch (moonshot smoke, 2 layers) equals
  ``grad_accum = W`` bit for bit; ``train(group=)`` at W = 2, with its
  preemptions and restores, equals ``train`` with ``grad_accum = 2``.
- The elastic pod-loss resume (``repro``'s ``test_elastic.py``): 4 ranks
  as (pod 2, data 2) train steps 0-5, save at 5, lose pod 1, and the 2
  survivors restore through ``CheckpointManager`` and train steps 5-10.
  The resumed global batch is ``8 x plan.batch_scale`` = 4, the plan's
  meaning of ``batch_scale``, so each rank's batch stays 2 (``repro``'s
  test keeps 8).  The survivors' steps equal one process replaying them
  from the same checkpoint at global batch 4 with ``grad_accum = 2``.

Each process runs one intra-op thread, as this module's does, so that the
one-process references sum in the same order; the ranks meet through a
``file://`` rendezvous under ``tmp_path``, so that test workers never
share a port.
"""
import dataclasses
import datetime
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs as TC
from repro_torch import sharding
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import restore_latest
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distributions, market, scenarios
from repro_torch.core.policies import checkpointing as C
from repro_torch.core.policies import solver_backends as SB
from repro_torch.data import SyntheticLM
from repro_torch.fault import plan_elastic_remesh
from repro_torch.launch import steps
from repro_torch.launch import train as TTR
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

J, DT, RO = 60, 1.0 / 12.0, 0.3
SOLVES = ([(b, obj, warm) for b in ("reference", "cuda")
           for obj in ("makespan", "dollars") for warm in (False, True)]
          + [("refine", obj, check) for obj in ("makespan", "dollars")
             for check in ("col0", "full")])
SEQ, BATCH, N_STEPS = 32, 8, 2
# the trainer's run of test_torch_train.py: preemptions at steps 16 and 36
TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=256)
RUN = dict(total_steps=40, sim_hours_per_step=0.05, preemption_seed=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- what every process computes alike ----------------------------------------

def _dists(n=8):
    return [sc.dist() for sc in scenarios.default_grid()][:n]


def _price():
    rng = np.random.default_rng(3)
    return market.PriceGrid.from_prices(rng.uniform(0.05, 0.6, (8, 96)), 0.25)


def _solve(case, dists, v_warm=None):
    kind, objective, opt = case
    kw = dict(grid_dt=DT, restart_overhead=RO, objective=objective,
              price=_price() if objective == "dollars" else None,
              device="cpu")
    if kind == "refine":
        return C.solve_batch(dists, J, backend="reference", refine=True,
                             refine_check=opt, **kw)
    return C.solve_batch(dists, J, backend=kind,
                         v_init=v_warm[objective] if opt else None, **kw)


def _warm_starts(dists):
    """2-sweep tables the warm cases start from, solved in one process."""
    return {obj: C.solve_batch(dists, J, grid_dt=DT, restart_overhead=RO,
                               objective=obj, n_sweeps=2, device="cpu",
                               price=_price() if obj == "dollars" else None
                               ).V for obj in ("makespan", "dollars")}


def _solves():
    dists = _dists()
    warm = _warm_starts(dists)
    return {case: _solve(case, dists, warm) for case in SOLVES}


def _cfg(arch="llama3.2-1b", **over):
    return dataclasses.replace(TC.smoke(arch), **over)


DENSE = dict(d_model=64, d_ff=128)          # repro's test_elastic config


def _model(cfg):
    return T.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                  trainable=True)


def _pipe(cfg, global_batch=BATCH):
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ,
                       global_batch=global_batch, seed=0, device="cpu")


def _rows(batch, rank, world):
    n = batch["labels"].shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _steps(cfg, group=None, accum=1, model=None, opt=None, pipe=None,
           start=0, end=N_STEPS, mgr=None):
    """Train steps ``start..end`` of ``pipe`` (this rank's rows of each
    global batch under ``group``); with ``mgr``, save on its schedule.
    Returns the model, the optimizer state and the losses."""
    model = _model(cfg) if model is None else model
    opt = adamw_init(dict(model.named_parameters())) if opt is None else opt
    pipe = _pipe(cfg) if pipe is None else pipe
    step_fn = steps.make_train_step(
        cfg, TrainConfig(warmup_steps=2, grad_accum=accum), group)
    rank, world = (0, 1) if group is None else (dist.get_rank(group),
                                                dist.get_world_size(group))
    losses = []
    for step in range(start, end):
        model, opt, m = step_fn(model, opt,
                                _rows(pipe.batch(step), rank, world))
        losses.append(float(m["loss"]))
        if mgr is not None and mgr.should_checkpoint(step + 1):
            mgr.save(step + 1, _state(model, opt))
    return model, opt, losses


def _state(model, opt):
    return {"params": dict(model.named_parameters()), "opt": opt}


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


# -- the ranks' work ----------------------------------------------------------

def _entry(rank, world, init, job, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res = globals()[job](rank, world, out)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _job_w4(rank, world, out):
    res = {}
    everyone = dist.group.WORLD
    # every rank takes part in creating every group
    singles = [dist.new_group([r]) for r in range(world)]
    with sharding.use(singles[rank]):
        res["one_rank"] = (SB.scenario_partition(8),
                           SB.shard_scenarios(_dists, 8, 0, 1)[0] is _dists)
    with sharding.use(everyone):
        res["partition"] = SB.scenario_partition(8)[1:]
        res["s6"] = (SB.scenario_partition(6),
                     SB.shard_scenarios(_dists, 6, 0, 1)[0] is _dists,
                     _solve(("cuda", "makespan", False), _dists(6)))
        res["solves"] = _solves()
        model, _, res["w4_losses"] = _steps(_cfg(compute_dtype="float32",
                                                 **DENSE), everyone)
    res["w4_params"] = _params(model)
    res["elastic"] = _elastic(rank, out)
    return res


def _elastic(rank, out):
    """repro's test_elastic on 4 ranks laid out as (pod 2, data 2), rank
    pod * 2 + d: steps 0-5, a save at 5, pod 1 lost, steps 5-10 on the
    survivors at the plan's batch scale."""
    cfg = _cfg(**DENSE)
    directory = os.path.join(out, "elastic")
    mgr = CheckpointManager(directory=directory,
                            dist=distributions.constrained_for(),
                            policy="fixed", fixed_interval_steps=3,
                            async_write=False, device="cpu",
                            write=rank == 0)
    everyone = dist.group.WORLD
    with sharding.use(everyone):
        model, opt, l1 = _steps(cfg, everyone, pipe=_pipe(cfg), end=5,
                                mgr=mgr)
        mgr.save(5, _state(model, opt))
    if rank == 0:
        shutil.copytree(os.path.join(directory, f"step_{5:010d}"),
                        os.path.join(out, "at5", f"step_{5:010d}"))
    plan = plan_elastic_remesh(2, [1], pod_shape=(2,), axes=("data",))
    survivors = [p * 2 + d for p in plan.surviving_pods for d in range(2)]
    group = dist.new_group(survivors)
    mgr.wait()
    dist.barrier()
    if rank not in survivors:
        return {"l1": l1, "survivor": False}
    restored = mgr.restore(_state(model, opt))
    state, step0, _ = restored
    opt = TTR._load(model, state)
    pipe = _pipe(cfg, int(BATCH * plan.batch_scale))
    with sharding.use(group):
        model, _, l2 = _steps(cfg, group, model=model, opt=opt, pipe=pipe,
                              start=step0, end=step0 + 5, mgr=mgr)
    return {"l1": l1, "l2": l2, "resumed": step0, "survivor": True,
            "global_batch": pipe.global_batch, "plan": plan,
            "params": _params(model)}


def _job_w2(rank, world, out):
    everyone = dist.group.WORLD
    res = {}
    with sharding.use(everyone):
        model, _, res["w2_losses"] = _steps(_cfg(**DENSE), everyone)
        res["w2_params"] = _params(model)
        model, _, res["moe_losses"] = _steps(_cfg("moonshot-v1-16b-a3b"),
                                             everyone)
        res["moe_params"] = _params(model)
    try:
        TTR.train(_cfg(**TINY), TrainConfig(ckpt_dir="unused"),
                  global_batch=3, total_steps=1, device="cpu",
                  group=everyone)
    except ValueError as e:
        res["refused"] = "does not split over 2 ranks" in str(e)
    got = TTR.train(_cfg(**TINY), TrainConfig(
        ckpt_dir=os.path.join(out, "train"), warmup_steps=5),
        inject_preemptions=True, verbose=False, device="cpu",
        group=everyone, **RUN)
    res["train"] = (got.losses, got.restarts, got.checkpoints,
                    got.emergency_checkpoints, got.wasted_steps,
                    _params(got.model))
    return res


def _spawn(job, world, out):
    mp.start_processes(_entry, args=(world, f"file://{out}/rendezvous", job,
                                     str(out)),
                       nprocs=world, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    out = tmp_path_factory.mktemp("w4")
    return out, _spawn("_job_w4", 4, out)


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    out = tmp_path_factory.mktemp("w2")
    return out, _spawn("_job_w2", 2, out)


@pytest.fixture(scope="module")
def one_process():
    return _solves()


def _same_tables(a, b):
    return torch.equal(a.V, b.V) and torch.equal(a.K, b.K)


def _same(xs, ys):
    return len(xs) == len(ys) and all(torch.equal(x, y)
                                      for x, y in zip(xs, ys))


# -- fallback -----------------------------------------------------------------

def test_no_group_takes_the_one_process_path():
    assert sharding.active_group() is None
    assert SB.scenario_partition(8) == (None, None, None)
    fn, sharded = SB.shard_scenarios(_dists, 8, 0, 1)
    assert fn is _dists and not sharded


def test_one_rank_group_takes_the_one_process_path(w4):
    for r in w4[1]:
        assert r["one_rank"] == ((None, None, None), True)


def test_world_not_dividing_s_takes_the_one_process_path(w4):
    want = _solve(("cuda", "makespan", False), _dists(6))
    for r in w4[1]:
        partition, same_fn, tables = r["s6"]
        assert partition == (None, None, None) and same_fn
        assert _same_tables(tables, want)


# -- the sharded solve --------------------------------------------------------

def test_every_rank_holds_its_block_of_the_partition(w4):
    assert [r["partition"] for r in w4[1]] == [(k, 4) for k in range(4)]


@pytest.mark.parametrize("case", SOLVES, ids=["-".join(map(str, c))
                                              for c in SOLVES])
def test_sharded_tables_equal_the_one_process_solve(w4, one_process, case):
    want = one_process[case]
    for r in w4[1]:
        got = r["solves"][case]
        assert _same_tables(got, want), case
        assert (got.objective, got.backend, got.refine_info) \
            == (want.objective, want.backend, want.refine_info)
        assert got.V.shape == (8, J + 1, int(round(24.0 / DT)) + 1)
    if case[0] == "refine":
        assert want.refine_info["applied"]
        assert want.refine_info["verified_col0"]


def test_sharded_solve_matches_repro_unsharded(w4):
    """The DP contract of docs/solver.md against repro's unsharded XLA
    solve of the same scenarios under x64."""
    import jax
    from repro.core import scenarios as JS
    from repro.core.policies import checkpointing as JC
    with jax.enable_x64(True):
        ref = JC.solve_batch([sc.dist() for sc in JS.default_grid()], J,
                             grid_dt=DT, restart_overhead=RO, backend="xla")
    got = w4[1][1]["solves"][("reference", "makespan", False)]
    np.testing.assert_allclose(got.V.numpy(), np.asarray(ref.V), rtol=1e-5,
                               atol=1e-5)
    assert (got.K.numpy() == np.asarray(ref.K)).mean() >= 0.995


# -- the data-parallel step ---------------------------------------------------

def test_two_ranks_equal_grad_accum_2_bit_for_bit(w2):
    model, _, losses = _steps(_cfg(**DENSE), accum=2)
    for r in w2[1]:
        assert r["w2_losses"] == losses
        assert _same(r["w2_params"], _params(model))


def test_four_ranks_within_grad_accum_tolerances(w4):
    model, _, losses = _steps(_cfg(compute_dtype="float32", **DENSE))
    for r in w4[1]:
        np.testing.assert_allclose(r["w4_losses"], losses, rtol=1e-5)
        for a, b in zip(r["w4_params"], _params(model)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("world,key", [(2, "w2_params"), (2, "moe_params"),
                                       (4, "w4_params")])
def test_ranks_hold_the_same_parameters(w2, w4, world, key):
    ranks = (w2 if world == 2 else w4)[1]
    for r in ranks[1:]:
        assert _same(r[key], ranks[0][key])


def test_moe_under_data_parallelism_equals_grad_accum_w(w2):
    model, _, losses = _steps(_cfg("moonshot-v1-16b-a3b"), accum=2)
    for r in w2[1]:
        assert r["moe_losses"] == losses
        assert _same(r["moe_params"], _params(model))


def test_train_with_a_group_equals_grad_accum(w2, tmp_path):
    want = TTR.train(_cfg(**TINY), TrainConfig(
        ckpt_dir=str(tmp_path), warmup_steps=5, grad_accum=2),
        inject_preemptions=True, verbose=False, device="cpu", **RUN)
    assert want.restarts >= 1
    for r in w2[1]:
        losses, restarts, ckpts, emergency, wasted, params = r["train"]
        assert losses == want.losses
        assert (restarts, ckpts, emergency, wasted) == (
            want.restarts, want.checkpoints, want.emergency_checkpoints,
            want.wasted_steps)
        assert _same(params, _params(want.model))
    # rank 0 wrote the checkpoints, and only its names are on disk
    assert sorted(os.listdir(w2[0] / "train")) == sorted(
        os.listdir(tmp_path))


def test_train_refuses_a_batch_the_group_does_not_split(w2):
    assert all(r["refused"] for r in w2[1])


# -- the elastic pod-loss resume ----------------------------------------------

def test_elastic_pod_loss_resume(w4):
    out, ranks = w4
    survivors = [r["elastic"] for r in ranks if r["elastic"]["survivor"]]
    assert len(survivors) == 2 and ranks[0]["elastic"]["survivor"]
    plan = survivors[0]["plan"]
    assert plan.surviving_pods == (0,) and plan.batch_scale == 0.5
    cfg = _cfg(**DENSE)
    model = _model(cfg)
    opt = adamw_init(dict(model.named_parameters()))
    state, step0, _ = restore_latest(str(out / "at5"), _state(model, opt))
    opt = TTR._load(model, state)
    model, _, want = _steps(cfg, accum=2, model=model, opt=opt,
                            pipe=_pipe(cfg, BATCH // 2), start=step0,
                            end=step0 + 5)
    for e in survivors:
        assert e["resumed"] == 5 and e["global_batch"] == 4
        assert all(np.isfinite(e["l1"])) and all(np.isfinite(e["l2"]))
        assert e["l2"][0] < e["l1"][0] + 1.0
        assert e["l2"] == want
        assert _same(e["params"], _params(model))
