"""Carry models and tables across from numpy.

These build the port's objects from plain numpy arrays - for instance the
dataclass fields of a ``repro`` distribution or the V/K arrays of a
``repro`` DP solve - so two implementations can be fed the same model and
the same tables.  Nothing here knows where the arrays came from.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .distributions import registry
from .policies.checkpointing import BatchDPTables, DPTables


def dist_from_numpy(family: str, fields: dict, device="cuda"):
    """The port's distribution of ``family`` (a key of
    ``distributions.registry()``, e.g. ``"diurnal_constrained"``) with each
    field a float64 tensor on ``device`` built from ``fields[name]``
    (scalars stay 0-d, stacked fields keep their leading axis)."""
    dev = resolve_device(device)
    cls = registry()[family]
    return cls(**{k: torch.as_tensor(np.array(v, np.float64), device=dev)
                  for k, v in fields.items()})


def batch_tables_from_numpy(V, K, *, grid_dt: float, delta_steps: int,
                            restart_overhead: float, horizon_idx: int,
                            objective: str = "makespan",
                            device="cuda") -> BatchDPTables:
    """A :class:`BatchDPTables` over float32 ``V`` and int32 ``K`` copied
    from ``(S, j_max+1, t_max+1)`` arrays onto ``device``."""
    dev = resolve_device(device)
    return BatchDPTables(
        V=torch.as_tensor(np.array(V, np.float32), device=dev),
        K=torch.as_tensor(np.array(K, np.int32), device=dev),
        grid_dt=float(grid_dt), delta_steps=int(delta_steps),
        restart_overhead=float(restart_overhead),
        horizon_idx=int(horizon_idx), backend="numpy", objective=objective)


def tables_from_numpy(V, K, *, grid_dt: float, delta_steps: int,
                      restart_overhead: float, horizon_idx: int,
                      objective: str = "makespan", device="cuda") -> DPTables:
    """A single-scenario :class:`DPTables` over float32 ``V`` and int32
    ``K`` copied from ``(j_max+1, t_max+1)`` arrays onto ``device``."""
    return batch_tables_from_numpy(
        np.asarray(V)[None], np.asarray(K)[None], grid_dt=grid_dt,
        delta_steps=delta_steps, restart_overhead=restart_overhead,
        horizon_idx=horizon_idx, objective=objective,
        device=device).tables(0)
