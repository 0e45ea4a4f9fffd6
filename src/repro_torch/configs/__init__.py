"""Architecture registry of the port: the configurations whose blocks the
port implements.

``get(arch_id)`` returns the full ModelConfig; ``smoke(arch_id)`` a reduced
same-family config for CPU tests.  IDs match ``repro.configs``.  The two
``embeds_input`` archs (musicgen-medium, qwen2-vl-2b with M-RoPE) take
precomputed embeddings through ``Model.forward(embeds=...)``, or tokens
through their embedding table.  The other architectures of the JAX package
need blocks the port does not have yet (MoE, xLSTM); asking for one raises
``KeyError`` (``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

import importlib

from .base import ModelConfig, ShapeConfig, TrainConfig, SHAPES  # noqa: F401

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "smollm-135m": "smollm_135m",
    "yi-34b": "yi_34b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCHS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet (ported: "
                       f"{sorted(_MODULES)}); ROADMAP.md lists what the "
                       f"others still need")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get(arch: str) -> ModelConfig:
    return _mod(arch).config()


def smoke(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
