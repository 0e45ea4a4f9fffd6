"""CUDA DP backend: adapter from the backend contract to the Hopper kernel
``kernels.dp_recurrence.dp_recurrence`` (the counterpart of ``repro``'s
``solver_backends/pallas.py``).

The kernel carries the restart-cost fixed point through its column-0
snapshot, so a warm start enters as the seed column ``v_init[:, :, 0]``
and a cold one as ``j*dt`` (makespan) or ``Pc[:, :j_max+1]`` (dollars).
A solve is one persistent kernel launch, all sweeps included, so
``dp_recurrence.launches`` grows by 1 per call.  Tolerance-tested against
the ``reference`` backend.
"""
from __future__ import annotations

from ....kernels.dp_recurrence import dp_recurrence
from .grids import seed_column


def solve_tables_batch(Fc, Hc, grid_dt, restart_overhead, v_init=None,
                       Pc=None, *, j_max: int, t_max: int, delta_steps: int,
                       n_sweeps: int):
    """Backend contract entry (see ``solver_backends``)."""
    col0 = seed_column(Fc, j_max, grid_dt, Pc, v_init)
    if Pc is None:
        return dp_recurrence(
            Fc, Hc, col0, grid_dt=float(grid_dt),
            restart_overhead=float(restart_overhead), j_max=j_max,
            t_max=t_max, delta_steps=delta_steps, n_sweeps=n_sweeps)
    return dp_recurrence(
        Fc, Hc, col0, grid_dt=float(grid_dt), restart_overhead=0.0,
        j_max=j_max, t_max=t_max, delta_steps=delta_steps, n_sweeps=n_sweeps,
        Pc=Pc, Ro=restart_overhead)
