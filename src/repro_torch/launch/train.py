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
hand-written flash backward.  ``repro``'s ``mesh`` and ``rules`` (XLA
sharding) have no counterpart here.

Run (any arch of ``configs.ARCHS``: the dense, embeds-input, hybrid
RG-LRU and MoE ones):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .. import configs
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
          verbose: bool = True, device="cuda") -> TrainResult:
    """Train ``cfg`` for ``total_steps`` steps on ``device``, resuming from
    the newest checkpoint in ``tc.ckpt_dir`` if there is one."""
    dev = resolve_device(device)
    dist = distributions.constrained_for(tc.vm_type)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch, seed=tc.seed,
                       device=str(dev))
    gen = torch.Generator(device=dev).manual_seed(tc.seed)

    model = T.init(cfg, gen, device=dev, trainable=True)
    opt_state = adamw_init(dict(model.named_parameters()))
    step_fn = steps.make_train_step(cfg, tc)

    mgr = CheckpointManager(
        directory=tc.ckpt_dir, dist=dist, policy=tc.ckpt_policy,
        delta_hours=tc.ckpt_cost_hours, step_time_hours=sim_hours_per_step,
        total_steps=total_steps, async_write=tc.async_checkpoint,
        device=str(dev))
    src = PreemptionSource(dist, n_pods=1, seed=preemption_seed,
                           device=str(dev)) if inject_preemptions else None
    dog = StragglerWatchdog()

    # resume if a checkpoint exists
    step = 0
    restarts = 0
    wasted = 0
    restored = mgr.restore(_state(model, opt_state))
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
        if src is not None:
            events = src.poll(sim_now)
            if events:
                # 30 s warning: emergency checkpoint, then the pod dies
                mgr.on_preemption_warning(step, _state(model, opt_state))
                # relaunch on a fresh pod + restore + replay pipeline
                restarts += 1
                src.replace_pod(0, sim_now)
                restored = mgr.restore(_state(model, opt_state))
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
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    tc = TrainConfig(ckpt_policy=args.ckpt_policy, ckpt_dir=args.ckpt_dir,
                     total_steps=args.steps)
    res = train(cfg, tc, total_steps=args.steps,
                inject_preemptions=args.preemptions, device=args.device)
    print(f"done: {res.steps_run} steps, final loss {res.final_loss:.4f}, "
          f"{res.restarts} restarts, {res.checkpoints} checkpoints "
          f"({res.emergency_checkpoints} emergency), "
          f"{res.wasted_steps} wasted steps")
    return res


if __name__ == "__main__":
    main()
