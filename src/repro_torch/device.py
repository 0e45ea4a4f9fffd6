"""Device resolution for the PyTorch port.

Every entry point of ``repro_torch`` takes ``device=`` and defaults to
``"cuda"``.  Asking for CUDA where there is none raises: the port never
falls back to the CPU on its own, so a number taken on the CPU cannot pass
for one taken on the card.  Callers that want the CPU (the parity tests)
say so with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
