"""Checkpointing with model-driven (DP) scheduling.

Port of ``repro.checkpoint.manager``, with the same mechanics:
  * a tree (nested dicts, lists, tuples and NamedTuples of tensors) is
    flattened to path -> array and written as ``arrays.npz`` beside a JSON
    manifest of shapes, dtypes, CRC32s and user metadata;
  * writes are atomic (a temporary directory, then a rename) and
    optionally asynchronous: the device -> host copy is synchronous, the
    disk write runs on a thread, so the writer never reads a CUDA tensor
    that the next step overwrites;
  * ``restore_latest`` scans the directory, verifies the CRCs and returns
    the newest intact checkpoint - a half-written one from a preempted pod
    is skipped, the failure mode the paper's 30 s warning window creates.

Keys are the port's own paths ("params/layers.3.attn.wq", "opt/mu/embed"),
so a checkpoint of ``repro`` does not restore here.

Scheduling: ``CheckpointManager`` consumes the paper's DP policy
(``core.policies.checkpointing.solve``, the ``dp_recurrence`` kernel on a
CUDA ``device``).  Given the fitted preemption model, the per-step time and
the checkpoint cost delta, it computes the optimal non-uniform schedule in
steps and answers ``should_checkpoint(step)``; ``"young_daly"``,
``"fixed"`` and ``"none"`` are the baselines.  The schedule logic is
``repro``'s line for line.  Planning the next checkpoint reads one entry
of K from the device (``DPTables.interval_steps``), a host sync.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..core.policies import checkpointing as ckpt_policy
from ..core.policies import young_daly


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def _items(node):
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if hasattr(node, "_fields"):                      # NamedTuple
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix="") -> dict:
    """{path: host numpy array}; the device -> host copy happens here."""
    items = _items(tree)
    if items is None:
        return {prefix[:-1]: tree.detach().cpu().numpy()}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _unflatten_like(template, flat: dict, prefix=""):
    """A tree shaped like ``template`` with the arrays of ``flat``, each
    as a tensor of its template leaf's dtype and device."""
    items = _items(template)
    if items is None:
        key = prefix[:-1]
        arr = flat[key]
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, template "
                             f"{tuple(template.shape)}")
        return torch.as_tensor(arr).to(device=template.device,
                                       dtype=template.dtype)
    values = [_unflatten_like(v, flat, f"{prefix}{k}/") for k, v in items]
    if isinstance(template, dict):
        return dict(zip(template.keys(), values))
    if hasattr(template, "_fields"):
        return type(template)(*values)
    return type(template)(values)


def save_checkpoint(directory: str, step: int, tree, metadata: Optional[dict]
                    = None, *, blocking: bool = True) -> threading.Thread:
    """Atomic (tmp + rename) checkpoint write; returns the writer thread."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)                 # the host copy is synchronous
    manifest = {
        "step": int(step),
        "time": time.time(),
        "metadata": metadata or {},
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes())}
                   for k, v in flat.items()},
    }

    def write():
        tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(directory, f"step_{int(step):010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def _verify(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for k, info in manifest["arrays"].items():
                arr = z[k]
                if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                        != info["crc32"]:
                    return None
        return manifest
    except Exception:       # any unreadable piece marks a torn write
        return None


def restore_latest(directory: str, template) -> Optional[tuple]:
    """Returns (tree, step, metadata) of the newest intact checkpoint, the
    tree's tensors on the devices and in the dtypes of ``template``'s."""
    if not os.path.isdir(directory):
        return None
    steps = sorted((d for d in os.listdir(directory) if d.startswith("step_")),
                   reverse=True)
    for d in steps:
        path = os.path.join(directory, d)
        manifest = _verify(path)
        if manifest is None:
            continue  # torn write (e.g. preempted mid-checkpoint) - skip
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return (_unflatten_like(template, flat), manifest["step"],
                manifest["metadata"])
    return None


# ---------------------------------------------------------------------------
# model-driven scheduling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointManager:
    """Owns the checkpoint schedule + IO for a training run on preemptible
    pods.

    policy: "dp" (the paper, non-uniform), "young_daly", "fixed", "none".
    Times are in hours of *pod age*; steps are mapped through the measured
    step time (EMA-updated online via ``observe_step_time``).  ``device``
    is where the DP is solved.  ``write=False`` keeps the schedule and the
    counts but writes no file: the ranks of a data-parallel run other than
    rank 0, which writes for all of them.
    """
    directory: str
    dist: Any                               # preemption model (core.distributions)
    policy: str = "dp"
    delta_hours: float = 1.0 / 60.0         # measured checkpoint write cost
    step_time_hours: float = 1.0 / 3600.0   # seed; EMA-updated
    total_steps: int = 1000
    pod_age_hours: float = 0.0              # age of the pod at run start
    grid_dt: float = 1.0 / 60.0
    async_write: bool = True
    fixed_interval_steps: int = 100
    device: str = "cuda"
    write: bool = True

    def __post_init__(self):
        self._tables = None
        self._next_ckpt_step: Optional[int] = None
        self._last_ckpt_step = 0
        self._pod_start_step = 0   # global step at which the current pod began
        self._writer: Optional[threading.Thread] = None
        self.n_saved = 0
        self.n_emergency = 0
        self._recompute()

    # -- schedule -----------------------------------------------------------
    def _recompute(self):
        if self.policy == "dp":
            remaining_h = (self.total_steps - self._last_ckpt_step) \
                * self.step_time_hours
            job_steps = max(int(round(remaining_h / self.grid_dt)), 1)
            # the DP table V/K covers EVERY remaining length j <= job_steps,
            # so restarts reuse it (the paper: "we precompute the
            # checkpointing schedule of jobs of different lengths") - only
            # solve when no table covers the need (e.g. step time grew)
            if self._tables is None or \
                    self._tables.V.shape[0] - 1 < job_steps:
                delta_steps = max(int(round(self.delta_hours / self.grid_dt)),
                                  1)
                self._tables = ckpt_policy.solve(
                    self.dist, job_steps, grid_dt=self.grid_dt,
                    delta_steps=delta_steps, device=self.device)
        self._plan_next()

    def _plan_next(self):
        step = self._last_ckpt_step
        if self.policy == "none":
            self._next_ckpt_step = None
        elif self.policy == "fixed":
            self._next_ckpt_step = step + self.fixed_interval_steps
        elif self.policy == "young_daly":
            mttf = young_daly.mttf_from_initial_rate(self.dist)
            tau_h = float(young_daly.interval(self.delta_hours, mttf))
            self._next_ckpt_step = step + max(
                int(round(tau_h / max(self.step_time_hours, 1e-9))), 1)
        else:  # dp
            # pod age counts only steps run on THIS pod (a restart resets it)
            age_h = self.pod_age_hours + \
                (step - self._pod_start_step) * self.step_time_hours
            remaining = self.total_steps - step
            rem_grid = max(int(round(remaining * self.step_time_hours
                                     / self.grid_dt)), 1)
            rem_grid = min(rem_grid, self._tables.V.shape[0] - 1)
            interval_grid = self._tables.interval_steps(
                rem_grid, int(round(age_h / self.grid_dt)))
            steps = max(int(round(interval_grid * self.grid_dt
                                  / max(self.step_time_hours, 1e-9))), 1)
            self._next_ckpt_step = step + steps

    # -- runtime hooks --------------------------------------------------------
    def observe_step_time(self, seconds: float, ema: float = 0.1):
        h = seconds / 3600.0
        self.step_time_hours = (1 - ema) * self.step_time_hours + ema * h

    def should_checkpoint(self, step: int) -> bool:
        return self._next_ckpt_step is not None and \
            step >= self._next_ckpt_step

    def save(self, step: int, tree, metadata=None, *, emergency: bool = False):
        if self._writer is not None:
            self._writer.join()  # one in-flight write at a time
        meta = dict(metadata or {})
        meta["policy"] = self.policy
        meta["emergency"] = emergency
        if self.write:
            self._writer = save_checkpoint(
                self.directory, step, tree, meta,
                blocking=not self.async_write or emergency)
        self._last_ckpt_step = step
        self.n_saved += 1
        if emergency:
            self.n_emergency += 1
        self._plan_next()

    def on_preemption_warning(self, step: int, tree, metadata=None):
        """The provider's 30 s warning: flush an emergency checkpoint NOW."""
        self.save(step, tree, metadata, emergency=True)

    def wait(self):
        """Block until the in-flight write, if any, is on disk."""
        if self._writer is not None:
            self._writer.join()

    def restore(self, template):
        self.wait()
        return restore_latest(self.directory, template)

    def on_restart(self, *, pod_age_hours: float = 0.0, resumed_step: int = 0):
        """Resume on a fresh pod: re-anchor ages and recompute the schedule
        (the paper recomputes E[M*(J_remaining, 0)] after every failure)."""
        self.pod_age_hours = pod_age_hours
        self._last_ckpt_step = resumed_step
        self._pod_start_step = resumed_step
        self._recompute()
