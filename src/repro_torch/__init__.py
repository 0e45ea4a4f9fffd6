"""PyTorch/CUDA port of ``repro`` (the JAX reference package).

The layout mirrors ``repro``: ``core/distributions.py`` (Eq. 1 lifetime
models), ``core/policies/`` (the Eq. 11-15 checkpointing DP and its solver
backends), ``core/engine.py`` (lifetime pools and the Monte-Carlo makespan
executor), ``core/scenarios.py`` (the scenario sweep) and ``kernels/`` (the
hand-written Hopper kernels, each beside its plain PyTorch version).

Entry points take ``device=`` and default to ``"cuda"``; see
:func:`repro_torch.device.resolve_device`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
