"""Checkpointing-DP recurrence (Eqs. 11-15): the Hopper kernel and its
plain PyTorch version.

:func:`dp_recurrence` is the port of the Pallas kernel
``repro/kernels/dp_recurrence.py``; its CUDA source is
``csrc/dp_recurrence.cu`` (what it computes, what bounds it and how it is
laid out are written at the top of that file).  A CPU tensor goes to
:func:`dp_recurrence_plain`; a CUDA tensor goes to the kernel, which is
built at first use, or the call raises.  The kernel runs a solve as one
persistent launch, all sweeps included, so ``dp_recurrence.launches``
grows by 1 a solve.

:func:`dp_recurrence_plain` repeats the kernel's arithmetic in float32
with the same in-lane recomputation of the failure probability and the
expected lost work, but evaluates all candidates of a row at once and
takes the first-match argmin.  The kernel is built without FMA contraction,
so each of its operations rounds as here; the contract they are held to is
V within rtol = atol = 1e-5 and K agreement >= 0.999 (makespan) or
>= 0.995 (dollars).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_EPS = 1e-9


def _check_inputs(Fc, Hc, col0, Pc, Ro, *, j_max, t_max, delta_steps,
                  n_sweeps):
    if Fc.ndim != 2 or Fc.shape[1] != t_max + 1:
        raise ValueError(f"Fc must be (S, t_max+1={t_max + 1}), got "
                         f"{tuple(Fc.shape)}")
    S = Fc.shape[0]
    want = {"Fc": (Fc, (S, t_max + 1)), "Hc": (Hc, (S, t_max + 1)),
            "col0": (col0, (S, j_max + 1))}
    if (Pc is None) != (Ro is None):
        raise ValueError("dollar mode needs both Pc and Ro")
    if Pc is not None:
        want["Pc"] = (Pc, (S, t_max + 1 + j_max + delta_steps))
        want["Ro"] = (Ro, (S,))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != Fc.device:
            raise ValueError(f"{name} is on {x.device}, Fc on {Fc.device}")
    if j_max < 0 or delta_steps < 0 or n_sweeps < 1:
        raise ValueError(f"need j_max >= 0, delta_steps >= 0, n_sweeps >= 1; "
                         f"got {j_max}, {delta_steps}, {n_sweeps}")


class Terms:
    """The per-candidate operands of the recurrence on ``(S, T)`` grids:
    the column-independent tensors :func:`candidate_terms` reads, built
    once per solve (``dtf`` is ``grid_dt`` as a float32 device tensor)."""

    def __init__(self, Fc, Hc, grid_dt: float, t_max: int, Pc=None):
        dev, f32 = Fc.device, torch.float32
        self.Fc, self.Hc, self.Pc, self.t_max = Fc, Hc, Pc, t_max
        self.dtf = torch.tensor(grid_dt, dtype=f32, device=dev)
        self.t = torch.arange(Fc.shape[1], device=dev)
        self.Ft, self.Ht = Fc[:, :, None], Hc[:, :, None]
        self.St = torch.clamp(1.0 - self.Ft, min=_EPS)
        self.tdt = (self.t.to(f32) * self.dtf)[None, :, None]
        self.Pt = None if Pc is None else Pc[:, :Fc.shape[1], None]


def candidate_terms(tm: Terms, w):
    """The operands of the candidates whose segment (work plus trailing
    checkpoint) spans ``w`` grid steps, ``w`` a 1-D tensor: the clipped end
    ages ``e`` ``(T, n)``, the failure probability ``p`` and expected lost
    work ``el`` ``(S, T, n)``, the segment hours ``wdt`` ``(n,)`` and, for
    dollars, the segment dollars ``dP`` and average price ``pb``
    ``(S, T, n)`` (else None).  Every element rounds alike whichever
    columns are evaluated together, so a caller may evaluate a row's
    candidates at once or hoist a whole candidate axis."""
    wdt = w.to(torch.float32) * tm.dtf
    endx = tm.t[:, None] + w[None, :]                  # (T, n)
    e = torch.clamp(endx, max=tm.t_max)
    dFe = tm.Fc[:, e] - tm.Ft                          # (S, T, n)
    p = torch.clamp(dFe / tm.St, 0.0, 1.0)
    dF = torch.clamp(dFe, min=_EPS)
    el = torch.minimum(
        torch.clamp((tm.Hc[:, e] - tm.Ht) / dF - tm.tdt, min=0.0), wdt)
    if tm.Pc is None:
        return e, p, el, wdt, None, None
    dP = tm.Pc[:, endx] - tm.Pt
    return e, p, el, wdt, dP, dP / wdt


def candidate_cost(p, el, wdt, vrow, Rj, dP=None, pb=None):
    """The expected cost of a candidate from its operands, the successor
    value ``vrow`` and the restart cost ``Rj`` (all broadcast)."""
    if dP is None:
        return (1.0 - p) * (wdt + vrow) + p * (el + Rj)
    return (1.0 - p) * (dP + vrow) + p * (el * pb + Rj)


def restart_base(Fc, restart_overhead: float, Ro=None):
    """What the restart-cost snapshot adds to column 0: the makespan
    overhead as a float32 device scalar, or the ``(S, 1)`` dollar one."""
    if Ro is None:
        return torch.tensor(restart_overhead, dtype=torch.float32,
                            device=Fc.device)
    return Ro[:, None]


def dp_recurrence_plain(Fc, Hc, col0, *, grid_dt: float,
                        restart_overhead: float, j_max: int, t_max: int,
                        delta_steps: int, n_sweeps: int, Pc=None, Ro=None):
    """The plain PyTorch version of :func:`dp_recurrence`, on any device."""
    _check_inputs(Fc, Hc, col0, Pc, Ro, j_max=j_max, t_max=t_max,
                  delta_steps=delta_steps, n_sweeps=n_sweeps)
    S, T = Fc.shape
    dev, f32 = Fc.device, torch.float32
    tm = Terms(Fc, Hc, grid_dt, t_max, Pc)
    dead = (1.0 - Fc) < 1e-6
    ro = restart_base(Fc, restart_overhead, Ro)
    V = torch.zeros((S, j_max + 1, T), dtype=f32, device=dev)
    K = torch.zeros((S, j_max + 1, T), dtype=torch.int32, device=dev)
    col = col0
    for _ in range(n_sweeps):
        R = ro + col                                   # sweep-start snapshot
        for j in range(1, j_max + 1):
            i = torch.arange(1, j + 1, device=dev)
            w = torch.where(i == j, i, i + delta_steps)
            e, p, el, wdt, dP, pb = candidate_terms(tm, w)
            vrow = V[:, (j - i)[None, :], e]
            cost = candidate_cost(p, el, wdt, vrow, R[:, j, None, None],
                                  dP, pb)
            V[:, j] = torch.where(dead, R[:, j, None], cost.amin(dim=2))
            K[:, j] = torch.where(dead, j, cost.argmin(dim=2) + 1).to(
                torch.int32)
        col = V[:, :, 0].clone()
    return V, K


@functools.cache
def _library():
    lib = _build.load("dp_recurrence")
    fn = lib.dp_recurrence_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dp_recurrence_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.dp_recurrence_workspace_bytes.restype = ctypes.c_longlong
    lib.dp_recurrence_error_string.argtypes = [ctypes.c_int]
    lib.dp_recurrence_error_string.restype = ctypes.c_char_p
    return lib


def dp_recurrence(Fc, Hc, col0, *, grid_dt: float, restart_overhead: float,
                  j_max: int, t_max: int, delta_steps: int, n_sweeps: int,
                  Pc=None, Ro=None):
    """Solve the batched checkpointing DP.

    Fc, Hc: (S, t_max+1) f32 CDF / partial-expectation grids; col0:
    (S, j_max+1) f32 seed for the restart-cost column (cold ``j*dt`` or a
    warm start's ``V[:, :, 0]``).  Returns (V, K), f32 and int32 tables of
    shape (S, j_max+1, t_max+1).

    Dollar objective: ``Pc`` is the (S, t_max+1+j_max+delta_steps) f32
    cumulative-dollar grid and ``Ro`` the (S,) f32 dollar restart overhead
    (``restart_overhead`` is then ignored); ``col0`` must be the dollar
    seed.
    """
    _check_inputs(Fc, Hc, col0, Pc, Ro, j_max=j_max, t_max=t_max,
                  delta_steps=delta_steps, n_sweeps=n_sweeps)
    dev = Fc.device
    if dev.type == "cpu":
        return dp_recurrence_plain(
            Fc, Hc, col0, grid_dt=grid_dt, restart_overhead=restart_overhead,
            j_max=j_max, t_max=t_max, delta_steps=delta_steps,
            n_sweeps=n_sweeps, Pc=Pc, Ro=Ro)
    if dev.type != "cuda":
        raise ValueError(f"dp_recurrence runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    lib = _library()
    S, T = Fc.shape
    V = torch.empty((S, j_max + 1, T), dtype=torch.float32, device=dev)
    K = torch.empty((S, j_max + 1, T), dtype=torch.int32, device=dev)
    work = torch.empty(lib.dp_recurrence_workspace_bytes(S, j_max, t_max),
                       dtype=torch.uint8, device=dev)
    price = Pc is not None
    with torch.cuda.device(dev):
        err = lib.dp_recurrence_launch(
            Fc.data_ptr(), Hc.data_ptr(), col0.data_ptr(),
            Pc.data_ptr() if price else None,
            Ro.data_ptr() if price else None,
            V.data_ptr(), K.data_ptr(), work.data_ptr(),
            S, j_max, t_max, delta_steps, n_sweeps,
            Pc.shape[1] if price else 0, float(grid_dt),
            float(restart_overhead),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dp_recurrence kernel failed: cudaError {err} "
                           f"({lib.dp_recurrence_error_string(err).decode()})")
    dp_recurrence.launches += 1
    return V, K


dp_recurrence.launches = 0
