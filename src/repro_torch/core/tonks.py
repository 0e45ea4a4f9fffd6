"""Tonks-gas analysis of constrained preemptions (the paper's Lemma; port
of ``repro.core.tonks``).

N mutually exclusive preemptions, each of duration w, inside [0, L] map
exactly onto a 1-D hard-rod (Tonks) gas: rods of length w on a segment of
length L.  The partition function is Z_N = (L - N w)^N and the probability
of finding a preemption starting at the last feasible instant is

    P(L - w) = Z_{N-1} / Z_N = 1 / (L - N w)  >  1/L        (the Lemma)

The exact quantities run in float64 on the device of a tensor argument,
else on ``device``; the Monte-Carlo sampler of valid configurations
(sorted uniforms on [0, L - Nw] plus i*w offsets) draws from a
``torch.Generator`` on its device.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .policies.scheduling import linspace

_F64 = torch.float64


def _f64(device, *xs):
    """``xs`` as float64 tensors on the first tensor's device, else on
    ``device``."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    dev = resolve_device(device) if dev is None else dev
    return [torch.as_tensor(x, dtype=_F64, device=dev) for x in xs]


def partition_function(N, L, w, device="cuda"):
    """Z_N = (L - N w)^N  (free 'temporal volume' to the N-th power)."""
    N, L, w = _f64(device, N, L, w)
    return torch.pow(torch.clamp(L - N * w, min=0.0), N)


def p_boundary(N, L, w, device="cuda"):
    """Exact P(L - w) = Z_{N-1}/Z_N = 1/(L - Nw) from the Lemma's proof."""
    N, L, w = _f64(device, N, L, w)
    return 1.0 / torch.clamp(L - N * w, min=1e-12)


def sample_configurations(generator: torch.Generator, n_samples: int, N: int,
                          L: float, w: float):
    """Uniform valid configurations of N non-overlapping preemptions: start
    times ``(n_samples, N)``, sorted along the last axis.  The map from
    sorted uniforms on [0, L - Nw] to ``y_(i) + (i-1) w`` is
    volume-preserving onto the hard-rod configuration space, so this
    samples the Tonks measure exactly."""
    Le = L - N * w
    if not Le > 0:
        raise ValueError(f"need N*w < L for any valid configuration; got "
                         f"N={N}, w={w}, L={L}")
    y = torch.rand((n_samples, N), generator=generator, dtype=_F64,
                   device=generator.device) * Le
    y = torch.sort(y, dim=-1).values
    return y + w * torch.arange(N, dtype=_F64, device=y.device)


def histogram(x, edges):
    """``jnp.histogram(x, bins=edges)``'s counts: bin ``k`` holds
    ``edges[k] <= x < edges[k+1]``, the last bin also ``x == edges[-1]``;
    values outside the edges are dropped.  Counted with ``bucketize`` and
    ``bincount`` (``torch.histogram`` has no CUDA implementation)."""
    n = edges.shape[0]
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], n - 1, idx)
    return torch.bincount(idx, minlength=n + 1)[1:n].to(x.dtype)


def start_density(generator: torch.Generator, n_samples: int, N: int,
                  L: float, w: float, n_bins: int = 48):
    """Monte-Carlo per-preemption start-time density rho(t), integrating to
    1: ``(centers, rho)``.  Excluded volume compresses the support to
    [0, L - w], lifting the density to ~1/(L - Nw) > 1/L on it."""
    x = sample_configurations(generator, n_samples, N, L, w).reshape(-1)
    edges = torch.as_tensor(linspace(0.0, L, n_bins + 1), device=x.device)
    counts = histogram(x, edges)
    rho = counts / (n_samples * N * (L / n_bins))
    return 0.5 * (edges[1:] + edges[:-1]), rho


def boundary_enhancement(generator: torch.Generator, n_samples: int, N: int,
                         L: float, w: float):
    """MC estimate of the per-preemption density at the last feasible start
    against the exact ``1/(L - Nw)``: the last start ``x_N`` lies within
    ``eps`` of its maximum with density ``N/(L - Nw)``.  Returns
    ``(mc_per_preemption, exact)``."""
    x = sample_configurations(generator, n_samples, N, L, w)
    eps = 0.02 * (L - N * w)
    frac = (x[:, -1] > (L - w - eps)).to(_F64).mean()
    return frac / eps / N, p_boundary(N, L, w, device=x.device)
