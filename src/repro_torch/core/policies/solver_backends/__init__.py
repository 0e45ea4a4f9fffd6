"""DP solver backends for the checkpointing DP (Eqs. 11-15).

``checkpointing.solve`` / ``solve_batch`` dispatch here.  Every backend
module implements one contract:

    solve_tables_batch(Fc, Hc, grid_dt, restart_overhead, v_init=None,
                       Pc=None, *, j_max, t_max, delta_steps, n_sweeps)
        -> (V, K)

with stacked ``(S, t_max+1)`` float32 grids (``grids.cdf_grids``) in and
``(S, j_max+1, t_max+1)`` tables out, on the grids' device; ``v_init``
warm-starts the restart-cost fixed point.  ``Pc=None`` selects the
makespan objective; an ``(S, t_max+1+j_max+delta_steps)`` cumulative-dollar
grid selects the dollar objective, and ``restart_overhead`` is then the
per-scenario ``(S,)`` float32 dollar overhead.  Backends:

  reference  the plain PyTorch recurrence, on any device;
  cuda       the hand-written Hopper kernel (CUDA tensors; CPU tensors go to
             the kernel wrapper's plain version).

Selection: an explicit ``backend=`` name always wins; ``"auto"`` takes the
``REPRO_SOLVER_BACKEND`` environment variable (``reference`` or ``cuda``)
when it is set, and otherwise picks ``cuda`` for a CUDA device and
``reference`` for any other, as ``repro`` applies its variable to
``"auto"`` only.

Scenario sharding: ``shard_scenarios`` splits a backend call's leading
``(S,)`` axis over the ranks of the process group that
``repro_torch.sharding.use`` made active, when the group has more than one
rank and its size divides S, and gathers the tables back so that every
rank holds all S; in every other case the call runs unwrapped, the exact
one-process path.  The scenarios' solves are independent, so sharded
tables equal unsharded ones bit for bit.  Both backends are sharded:
``repro`` leaves its serial ``reference`` oracle unsharded and shards
``xla``, its batched default off the TPU, and the port's ``reference`` is
that batched default (the plain recurrence), not a serial oracle.
"""
from __future__ import annotations

import os

import torch

from .... import sharding as _sharding
from . import cuda, grids, reference

BACKENDS = ("reference", "cuda")
ENV_VAR = "REPRO_SOLVER_BACKEND"

_MODULES = {"reference": reference, "cuda": cuda}


def resolve(backend: str = "auto", device="cpu") -> str:
    """Resolve a ``backend=`` argument to a concrete backend name.  The
    ``REPRO_SOLVER_BACKEND`` override applies only to ``"auto"``: code that
    asks for a backend by name gets that backend."""
    if backend == "auto":
        env = os.environ.get(ENV_VAR, "").strip().lower()
        if env:
            backend = env
        else:
            backend = "cuda" if torch.device(device).type == "cuda" \
                else "reference"
    if backend not in BACKENDS:
        raise ValueError(f"unknown solver backend {backend!r}; expected one "
                         f"of {('auto',) + BACKENDS} (or {ENV_VAR} in "
                         f"{BACKENDS})")
    return backend


def get(name: str):
    """The backend module for a resolved name."""
    return _MODULES[name]


def scenario_partition(n_scenarios: int):
    """``(group, rank, world)`` for splitting ``n_scenarios`` over the
    active process group, or ``(None, None, None)`` when no group is
    active, it has one rank, or its size does not divide S: every such
    case takes the unwrapped one-process path."""
    group = _sharding.active_group()
    if group is None:
        return None, None, None
    world = torch.distributed.get_world_size(group)
    if world == 1 or int(n_scenarios) % world:
        return None, None, None
    return group, torch.distributed.get_rank(group), world


def shard_scenarios(fn, n_scenarios: int, n_args: int, n_out: int):
    """Wrap ``fn(*tensors) -> tuple`` (every input and output carrying a
    leading ``(S,)`` axis) so that each rank of the active group calls it
    on its contiguous block of S / world scenarios and every output is
    gathered along axis 0, each rank then holding the whole of it.

    Returns ``(wrapped_fn, sharded)``; when no partition applies the
    original ``fn`` comes back untouched (``sharded=False``).  Every rank
    of the group must make the same calls in the same order (SPMD)."""
    group, rank, world = scenario_partition(n_scenarios)
    if group is None:
        return fn, False
    block = int(n_scenarios) // world

    def wrapped(*args):
        if len(args) != n_args:
            raise TypeError(f"shard_scenarios: {len(args)} arguments, "
                            f"expected {n_args}")
        outs = fn(*(a[rank * block:(rank + 1) * block].contiguous()
                    for a in args))
        if len(outs) != n_out:
            raise TypeError(f"shard_scenarios: {len(outs)} outputs, "
                            f"expected {n_out}")
        return tuple(_sharding.all_gather_cat(o, group) for o in outs)

    return wrapped, True


__all__ = ["BACKENDS", "resolve", "get", "grids", "scenario_partition",
           "shard_scenarios"]
