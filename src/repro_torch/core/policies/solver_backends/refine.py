"""Coarse-to-fine DP refinement (port of ``repro``'s
``solver_backends/refine.py``): solve at ``factor x grid_dt``, prune the
pre-sweeps to the coarse argmin's neighbourhood and the restart-cost
dependency cone, verify, then run one full-resolution sweep through the
solve's own backend.

Why this is sound
-----------------
Sweeps couple ONLY through the restart-cost column ``V[:, :, 0]``
(``R_j = overhead + V_prev[j, 0]``; one warm sweep from a 3-sweep ``V``
equals the 4-sweep cold solve bit for bit).  So only the FINAL sweep has to
run at full resolution over the full candidate axis; the ``n_sweeps - 1``
sweeps before it exist to reproduce the restart-cost trajectory, and those
are pruned:

  * **the column-0 dependency cone**: ``V[j, 0]`` transitively reads row
    ``j'`` at ages ``t <= M(j') = (1 + delta) * (j_max - j')`` (from
    ``(j, t)`` with ``t <= M(j)`` the body reads ``(j - i, t + i + delta)``
    and ``M(j) + i + delta <= M(j - i)``).  Pre-sweeps compute each row
    segment only out to its cone extent; ages beyond a row's own cone may
    read unwritten zeros from deeper rows, but by the same induction
    nothing inside the cone reads them.
  * **candidate-prefix caps near the coarse argmin**: per row segment the
    candidate axis is capped at ``factor * max(K_c over the segment's
    cone) + radius`` (the run-to-completion candidate ``i == j`` is always
    kept).  A min over a candidate prefix equals the full min whenever the
    prefix holds a minimizer, and ``amin`` is exact in any order.

Every candidate's cost comes from ``kernels.dp_recurrence``'s
``candidate_terms`` / ``candidate_cost``, the plain version's own
expression, on column slices of grids hoisted over the whole candidate
axis, so each element rounds as in the plain solve.

Verification: after each pre-sweep, column 0 is recomputed at FULL
candidate width from the pre-sweep table and compared bit for bit, one
``ok`` flag a scenario; a mismatch means a cap cut off an argmin where the
restart-cost chain reads, and the dispatcher falls back to the plain solve.
The check is necessary, not sufficient, so ``refine_check="full"`` in
``solve_batch`` also compares the whole table.

The final sweep is the backend's own solve with ``n_sweeps=1``, seeded
with the pre-swept column 0 (a warm start): on the card one
``dp_recurrence`` launch, on the CPU its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from ....kernels.dp_recurrence import (Terms, candidate_cost,
                                       candidate_terms, restart_base)
from .grids import seed_column

# pre-sweeps split the j axis into this many segments so each segment's
# age extent hugs the dependency cone
_N_CONE_SEGS = 6


def plan(j_max: int, t_max: int, delta_steps: int, n_sweeps: int,
         factor: int, radius):
    """Static refinement plan, or None when refinement cannot help (grid too
    small for a meaningful coarse level, or nothing to prune: with
    ``n_sweeps == 1`` there are no pre-sweeps)."""
    factor = int(factor)
    if radius is None:
        # the coarse argmin locates the fine argmin to ~factor steps; pad x3
        # so hint error from the coarser delta/deadline rounding stays inside
        radius = 3 * factor
    radius = int(radius)
    if (factor < 2 or n_sweeps < 2 or j_max < 4 * factor
            or t_max < 4 * factor):
        return None
    return {
        "factor": factor,
        "radius": radius,
        "j_max_c": max(1, (j_max + factor // 2) // factor),
        "delta_steps_c": max(1, (delta_steps + factor // 2) // factor),
    }


def cone_segments(j_max: int, t_max: int, delta_steps: int):
    """(lo, hi, age_extent) segments covering rows 1..j_max, each clipped to
    the column-0 dependency cone ``ages <= (1+delta)*(j_max - lo)``."""
    n_seg = _N_CONE_SEGS if j_max >= 8 * _N_CONE_SEGS else 1
    bounds = [1 + (k * j_max) // n_seg for k in range(n_seg)] + [j_max + 1]
    segs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if lo >= hi:
            continue
        A = min(t_max + 1, (1 + delta_steps) * (j_max - lo) + 1)
        segs.append((lo, hi, max(A, 1)))
    return segs


def candidate_caps(Kc, segs, *, factor: int, radius: int, j_max_c: int,
                   t_max_c: int):
    """Per-segment candidate-axis caps from the coarse argmin table (host
    numpy): ``factor * K_c + radius`` over every (scenario, row, cone age)
    the segment touches, so spread-out argmins degrade a cap toward the
    full axis instead of going wrong."""
    if isinstance(Kc, torch.Tensor):
        Kc = Kc.cpu().numpy()
    Kc = np.asarray(Kc)
    caps = []
    for lo, hi, A in segs:
        jlo_c = min(max((lo + factor // 2) // factor, 0), j_max_c)
        jhi_c = min(max((hi - 1 + factor // 2) // factor, 0), j_max_c)
        thi_c = min(max((A - 1 + factor // 2) // factor, 0), t_max_c)
        kmax = int(Kc[:, jlo_c:jhi_c + 1, :thi_c + 1].max())
        cap = min(hi - 1, factor * kmax + radius)
        caps.append(max(cap, 1))
    return tuple(caps)


class _Grids:
    """The candidate operands hoisted over the whole candidate axis
    ``i = 1..j_max``: ``nf`` with a trailing checkpoint (``w = i + delta``,
    every candidate ``i < j``) and ``fd`` without (``w = i``, the final
    segment ``i == j``), each ``candidate_terms``' tuple."""

    def __init__(self, Fc, Hc, grid_dt, Pc, *, j_max, t_max, delta_steps):
        tm = Terms(Fc, Hc, grid_dt, t_max, Pc)
        i = torch.arange(1, j_max + 1, device=Fc.device)
        self.nf = candidate_terms(tm, i + delta_steps)
        self.fd = candidate_terms(tm, i)


def _cut(terms, ages, cols):
    """Age and candidate slices of a ``candidate_terms`` tuple."""
    e, p, el, wdt, dP, pb = terms
    grid = lambda x: None if x is None else x[:, ages, cols]  # noqa: E731
    return e[ages, cols], grid(p), grid(el), wdt[cols], grid(dP), grid(pb)


def _row_values(g, V, R, dead_a, j, A, cap):
    """Row ``j``'s values at ages ``:A`` over the candidates ``1..cap``
    (those below ``j``) and the final segment ``i == j``."""
    e, p, el, wdt, dP, pb = _cut(g.fd, slice(0, A), j - 1)
    Rj = R[:, j, None]
    v = candidate_cost(p, el, wdt, V[:, 0, e], Rj, dP, pb)
    n = min(cap, j - 1)
    if n > 0:
        e, p, el, wdt, dP, pb = _cut(g.nf, slice(0, A), slice(0, n))
        i = torch.arange(1, n + 1, device=V.device)
        cost = candidate_cost(p, el, wdt, V[:, (j - i)[None, :], e],
                              Rj[:, :, None], dP, pb)
        v = torch.minimum(cost.amin(dim=2), v)
    return torch.where(dead_a, Rj, v)


def _col0_check(g, V, R, dead):
    """Column 0 of every row recomputed over the FULL candidate axis from
    the pre-sweep table (the rows read only entries already written) and
    compared bit for bit: ``(S,)`` ok flags."""
    j_max = V.shape[1] - 1
    dev = V.device
    rows = torch.arange(1, j_max + 1, device=dev)
    e, p, el, wdt, dP, pb = _cut(g.fd, 0, rows - 1)
    Rj = R[:, 1:]
    v = candidate_cost(p, el, wdt, V[:, 0, e], Rj, dP, pb)      # (S, J)
    if j_max > 1:
        i = torch.arange(1, j_max, device=dev)
        e, p, el, wdt, dP, pb = _cut(g.nf, 0, slice(0, j_max - 1))
        src = torch.clamp(rows[:, None] - i[None, :], min=0)   # (J, J-1)
        unsq = lambda x: None if x is None else x[:, None, :]  # noqa: E731
        cost = candidate_cost(unsq(p), unsq(el), wdt,
                              V[:, src, e[None, :]], Rj[:, :, None],
                              unsq(dP), unsq(pb))
        cost = torch.where(i[None, :] < rows[:, None], cost, torch.inf)
        v = torch.minimum(cost.amin(dim=2), v)
    v = torch.where(dead[:, :1], Rj, v)
    return (v == V[:, 1:, 0]).all(dim=1)


def _cone_presweep(g, segs, caps, col0, ro, dead):
    """One pruned value-only sweep from the restart column ``col0``.
    Returns (new column 0, ok flags)."""
    S, J1 = col0.shape
    R = ro + col0
    V = torch.zeros((S, J1, dead.shape[1]), dtype=torch.float32,
                    device=col0.device)
    for (lo, hi, A), cap in zip(segs, caps):
        for j in range(lo, hi):
            V[:, j, :A] = _row_values(g, V, R, dead[:, :A], j, A, cap)
    return V[:, :, 0].clone(), _col0_check(g, V, R, dead)


def refined_solve(backend, Fc, Hc, grid_dt, restart_overhead, v_init=None,
                  Pc=None, *, caps, j_max: int, t_max: int, delta_steps: int,
                  n_sweeps: int):
    """The fine-level pipeline: ``n_sweeps - 1`` pruned pre-sweeps, then ONE
    full-resolution sweep through ``backend`` (a ``solver_backends``
    module) seeded with their column 0.  ``restart_overhead`` follows the
    backend contract (hours, or the ``(S,)`` dollar overhead with ``Pc``).
    Returns ``(V, K, ok)`` with ``ok`` the ``(S,)`` verification flags."""
    g = _Grids(Fc, Hc, grid_dt, Pc, j_max=j_max, t_max=t_max,
               delta_steps=delta_steps)
    dead = (1.0 - Fc) < 1e-6
    Ro = None if Pc is None else restart_overhead
    ro = restart_base(Fc, restart_overhead, Ro)
    segs = cone_segments(j_max, t_max, delta_steps)
    col0 = seed_column(Fc, j_max, grid_dt, Pc, v_init)
    ok = torch.ones(Fc.shape[0], dtype=torch.bool, device=Fc.device)
    for _ in range(n_sweeps - 1):
        col0, ok_k = _cone_presweep(g, segs, caps, col0, ro, dead)
        ok &= ok_k
    seed = col0[:, :, None].expand(col0.shape[0], j_max + 1, t_max + 1)
    V, K = backend.solve_tables_batch(
        Fc, Hc, grid_dt, restart_overhead, seed, Pc, j_max=j_max,
        t_max=t_max, delta_steps=delta_steps, n_sweeps=1)
    return V, K, ok
