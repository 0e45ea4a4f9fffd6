"""Plain DP backend: the batched PyTorch recurrence
(``kernels.dp_recurrence.dp_recurrence_plain``) on any device.  It is the
yardstick the CUDA backend is held to, and the backend ``"auto"`` picks on
the CPU."""
from __future__ import annotations

from ....kernels.dp_recurrence import dp_recurrence_plain
from .grids import seed_column


def solve_tables_batch(Fc, Hc, grid_dt, restart_overhead, v_init=None,
                       Pc=None, *, j_max: int, t_max: int, delta_steps: int,
                       n_sweeps: int):
    """Backend contract entry (see ``solver_backends``)."""
    col0 = seed_column(Fc, j_max, grid_dt, Pc, v_init)
    if Pc is None:
        return dp_recurrence_plain(
            Fc, Hc, col0, grid_dt=float(grid_dt),
            restart_overhead=float(restart_overhead), j_max=j_max,
            t_max=t_max, delta_steps=delta_steps, n_sweeps=n_sweeps)
    return dp_recurrence_plain(
        Fc, Hc, col0, grid_dt=float(grid_dt), restart_overhead=0.0,
        j_max=j_max, t_max=t_max, delta_steps=delta_steps, n_sweeps=n_sweeps,
        Pc=Pc, Ro=restart_overhead)
