"""Shared DP grid construction: the discretized lifetime CDF, its
partial-expectation companion, the cumulative-dollar grid and the
restart-cost seed column.

  ``Fc[t]``  the lifetime CDF on the age grid, with the provider-kill atom
             at the deadline ``L`` folded into the last cell (``Fc[-1] = 1``);
  ``Hc[t]``  the partial expectation ``H(t) = int_0^t x dF~(x)`` including
             the same atom (``Hc[-1] += atom * L``).

Both are computed in float64 and cast to the solver's float32 once, at the
end, as ``repro``'s grids are under x64.
"""
from __future__ import annotations

import numpy as np
import torch

# Shared guard against zero survival/failure mass in the conditional forms.
_EPS = 1e-9


def cdf_grids(dist, grid_dt: float, device=None):
    """``(Fc, Hc, t_max)`` for one distribution: float32 ``(t_max+1,)``
    tensors on ``device`` (default: the distribution's device), with
    ``t_max = round(L / grid_dt)``."""
    L = float(dist.L)
    t_max = int(round(L / grid_dt))
    dev = dist.device if device is None else torch.device(device)
    tk = torch.arange(t_max + 1, dtype=torch.float64, device=dev) * grid_dt
    F_raw = torch.clamp(dist.cdf(tk), 0.0, 1.0)
    atom = torch.clamp(1.0 - F_raw[-1], min=0.0)          # provider kill at L
    Fc = F_raw.clone()
    Fc[-1] = 1.0
    Hc = dist.partial_expectation(torch.zeros_like(tk), tk).clone()
    Hc[-1] += atom * L
    return Fc.to(torch.float32), Hc.to(torch.float32), t_max


def price_cum_grids(prices, cum, price_dt: float, grid_dt: float,
                    t_max: int, ext: int):
    """Cumulative-dollar grid on the DP age axis (host numpy).

    ``prices``/``cum``/``price_dt`` are a price grid's fields: ``prices`` is
    ``(S, T_price)`` $/hour cells, ``cum[s, k]`` the dollars accrued through
    the first ``k`` cells.  Returns ``(Pc, P0)``: ``Pc`` float32
    ``(S, t_max + 1 + ext)``, the dollars accrued by a VM of age
    ``m * grid_dt`` (piecewise linear between cell edges, ages beyond the
    price horizon billed at the final cell's price), and ``P0`` float64
    ``(S,)``, the launch-cell price.  The ``ext`` extra cells let the
    recurrence's ``t + w`` segment-cost gathers run unclipped."""
    prices = np.asarray(prices, np.float64)
    cum = np.asarray(cum, np.float64)
    pdt = float(price_dt)
    tau = np.arange(t_max + 1 + ext, dtype=np.float64) * float(grid_dt)
    k = np.clip(np.floor(tau / pdt).astype(np.int64), 0, prices.shape[1] - 1)
    Pc = cum[:, k] + prices[:, k] * (tau[None, :] - k[None, :] * pdt)
    return np.ascontiguousarray(Pc, np.float32), prices[:, 0].copy()


def seed_column(Fc, j_max: int, grid_dt: float, Pc=None, v_init=None):
    """The ``(S, j_max+1)`` float32 restart-cost seed column: the cold
    makespan seed ``j * dt``, the cold dollar seed ``Pc[:, :j_max+1]``, or a
    warm start's ``v_init[:, :, 0]`` (sweeps couple only through column 0)."""
    if v_init is not None:
        return v_init[:, :, 0].to(torch.float32).contiguous()
    if Pc is not None:
        return Pc[:, :j_max + 1].to(torch.float32).contiguous()
    col = (torch.arange(j_max + 1, dtype=torch.float64, device=Fc.device)
           * grid_dt).to(torch.float32)
    return col.expand(Fc.shape[0], j_max + 1).contiguous()
