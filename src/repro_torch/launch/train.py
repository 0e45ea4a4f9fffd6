"""End-to-end preemption-aware training driver.

Port of ``repro.launch.train``, the integration point of the paper's
contribution with the training substrate: the loop trains a model on the
synthetic pipeline while

  * a ``PreemptionSource`` (bathtub model) delivers simulated pod
    preemptions with the provider's 30 s warning,
  * a ``CheckpointManager`` runs the paper's DP checkpoint schedule
    (non-uniform, pod-age-dependent; the ``dp_recurrence`` kernel on the
    card) and flushes an emergency checkpoint inside the warning window,
  * on pod loss the job restarts on a replacement pod, restores the newest
    intact checkpoint, replays the deterministic data pipeline to the
    resumed step, and recomputes the DP schedule (the paper's resume rule),
  * a ``StragglerWatchdog`` watches the step times.

Simulated time: ``sim_hours_per_step`` maps steps to pod age so a short run
can traverse hours of the preemption model.  The model trains in float32
master weights with ``cfg.compute_dtype`` compute; on the card every
attention layer runs the flash forward (with its log-sum-exp) and the
hand-written flash backward.  ``repro``'s ``mesh`` has its counterpart in
``group``: data parallelism over a ``torch.distributed`` process group
(see :func:`train`); its ``rules`` (XLA layouts) have none.

Run (any arch of ``configs.ARCHS``: the dense, embeds-input, hybrid
RG-LRU, MoE and xLSTM ones):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b --smoke --device cpu

``--trace`` records the steps' spans (``repro_torch.tracing``) and prints
their summary after the run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from .. import configs, sharding, tracing
from ..checkpoint import CheckpointManager
from ..configs.base import TrainConfig
from ..core import distributions
from ..data.pipeline import SyntheticLM
from ..device import resolve_device
from ..fault import PreemptionSource, StragglerWatchdog
from ..models import transformer as T
from ..optim import adamw_init
from . import steps


@dataclasses.dataclass
class TrainResult:
    losses: list
    steps_run: int
    restarts: int
    checkpoints: int
    emergency_checkpoints: int
    wasted_steps: int
    final_loss: float
    # the trained model (repro's result has no params; a replayed run is
    # held to a clean one by its final parameters)
    model: Optional[torch.nn.Module] = dataclasses.field(default=None,
                                                         repr=False)


def _state(model, opt_state):
    return {"params": dict(model.named_parameters()), "opt": opt_state}


def _load(model, restored):
    """Copy a restored state's parameters into ``model``; returns its
    optimizer state."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(restored["params"][name])
    return restored["opt"]


def train(cfg, tc: TrainConfig, *, total_steps: int = 200,
          seq_len: int = 64, global_batch: int = 8,
          inject_preemptions: bool = False, sim_hours_per_step: float = 0.02,
          preemption_seed: int = 7, log_every: int = 25,
          verbose: bool = True, device="cuda", group=None) -> TrainResult:
    """Train ``cfg`` for ``total_steps`` steps on ``device``, resuming from
    the newest checkpoint in ``tc.ckpt_dir`` if there is one.

    With a ``torch.distributed`` ``group`` of W ranks, each of which makes
    this call with the same arguments, the run is data parallel: rank 0
    broadcasts the initial parameters; each rank trains on rows
    ``[r B / W, (r + 1) B / W)`` of ``pipe.batch(step)``, the global batch
    of one process (``make_train_step`` averages the gradients); the body
    runs under ``sharding.use(group)``; every rank keeps the checkpoint
    schedule and only rank 0 writes; before a restore rank 0's write is on
    disk and the group meets at a barrier; and each step the ranks check
    that they agree on the step, the checkpoints and the preemptions."""
    dev = resolve_device(device)
    world = 1 if group is None else tdist.get_world_size(group)
    rank = 0 if group is None else tdist.get_rank(group)
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{world} ranks")
    rows = global_batch // world
    dist = distributions.constrained_for(tc.vm_type)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch, seed=tc.seed,
                       device=str(dev))
    gen = torch.Generator(device=dev).manual_seed(tc.seed)

    model = T.init(cfg, gen, device=dev, trainable=True)
    if world > 1:
        with torch.no_grad():
            for p in model.parameters():
                sharding.broadcast_(p, group)
    opt_state = adamw_init(dict(model.named_parameters()))
    step_fn = steps.make_train_step(cfg, tc, group)

    def restore():
        mgr.wait()
        if world > 1:
            tdist.barrier(group=group)
        return mgr.restore(_state(model, opt_state))

    with sharding.use(group):
        mgr = CheckpointManager(
            directory=tc.ckpt_dir, dist=dist, policy=tc.ckpt_policy,
            delta_hours=tc.ckpt_cost_hours,
            step_time_hours=sim_hours_per_step, total_steps=total_steps,
            async_write=tc.async_checkpoint, device=str(dev),
            write=rank == 0)
        src = PreemptionSource(dist, n_pods=1, seed=preemption_seed,
                               device=str(dev)) if inject_preemptions \
            else None
        dog = StragglerWatchdog()

        # resume if a checkpoint exists
        step = 0
        restarts = 0
        wasted = 0
        restored = restore()
        if restored is not None:
            state, step, _ = restored
            opt_state = _load(model, state)
            if verbose:
                print(f"resumed from checkpoint at step {step}")

        losses = []
        sim_now = 0.0
        while step < total_steps:
            t0 = time.time()
            batch = pipe.batch(step)
            if world > 1:
                batch = {k: v[rank * rows:(rank + 1) * rows]
                         for k, v in batch.items()}
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            step += 1
            sim_now += sim_hours_per_step
            mgr.observe_step_time(sim_hours_per_step * 3600.0)
            dog.observe(time.time() - t0)

            if verbose and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"grad {float(metrics['grad_norm']):.3f} "
                      f"ckpts {mgr.n_saved}")

            # --- the paper's policies in action ---
            if mgr.should_checkpoint(step):
                mgr.save(step, _state(model, opt_state))
            events = src.poll(sim_now) if src is not None else []
            if world > 1:
                sharding.check_same([step, mgr.n_saved, len(events)], group,
                                    "the step, the checkpoints and the "
                                    "preemptions")
            if events:
                # 30 s warning: emergency checkpoint, then the pod dies
                mgr.on_preemption_warning(step, _state(model, opt_state))
                # relaunch on a fresh pod + restore + replay pipeline
                restarts += 1
                src.replace_pod(0, sim_now)
                restored = restore()
                if restored is None:
                    raise RuntimeError("no intact checkpoint after the "
                                       "emergency save")
                state, ckpt_step, _ = restored
                opt_state = _load(model, state)
                wasted += step - ckpt_step
                step = ckpt_step
                mgr.on_restart(pod_age_hours=0.0, resumed_step=step)
                if verbose:
                    print(f"  !! pod preempted at sim t={sim_now:.2f}h -> "
                          f"restart from step {step}")

        mgr.wait()      # the last checkpoint is on disk when the run returns
    return TrainResult(losses=losses, steps_run=len(losses),
                       restarts=restarts, checkpoints=mgr.n_saved,
                       emergency_checkpoints=mgr.n_emergency,
                       wasted_steps=wasted,
                       final_loss=float(np.mean(losses[-10:])), model=model)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preemptions", action="store_true")
    ap.add_argument("--ckpt-policy", default="dp",
                    choices=("dp", "young_daly", "fixed", "none"))
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", action="store_true",
                    help="record spans and print their summary")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    tc = TrainConfig(ckpt_policy=args.ckpt_policy, ckpt_dir=args.ckpt_dir,
                     total_steps=args.steps)
    with tracing.recording() if args.trace else contextlib.nullcontext():
        res = train(cfg, tc, total_steps=args.steps,
                    inject_preemptions=args.preemptions, device=args.device)
    print(f"done: {res.steps_run} steps, final loss {res.final_loss:.4f}, "
          f"{res.restarts} restarts, {res.checkpoints} checkpoints "
          f"({res.emergency_checkpoints} emergency), "
          f"{res.wasted_steps} wasted steps")
    if args.trace:
        print(tracing.table(tracing.summary()))
    return res


if __name__ == "__main__":
    main()
