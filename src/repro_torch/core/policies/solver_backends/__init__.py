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
"""
from __future__ import annotations

import os

import torch

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


__all__ = ["BACKENDS", "resolve", "get", "grids"]
