"""Architecture registry of the port: the configurations whose blocks the
port implements.

``get(arch_id)`` returns the full ModelConfig; ``smoke(arch_id)`` a reduced
same-family config for CPU tests.  IDs match ``repro.configs``.  The two
``embeds_input`` archs (musicgen-medium, qwen2-vl-2b with M-RoPE) take
precomputed embeddings through ``Model.forward(embeds=...)``, or tokens
through their embedding table; qwen2-vl-2b's entry is ``repro``'s
backbone, and ``qwen2_vl_2b.whole_config()`` the whole model, vision
tower and q/k/v biases included, which computes its image features and
M-RoPE positions from ``pixels`` and ``grids``; the two MoE archs (moonshot-v1-16b-a3b,
phi3.5-moe-42b-a6.6b) run ``models/moe.py``'s block, and xlstm-1.3b
``models/xlstm.py``'s mLSTM and sLSTM blocks.  Every architecture of the
JAX package's registry is here; an unknown ID raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig, ShapeConfig, TrainConfig, SHAPES  # noqa: F401

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "smollm-135m": "smollm_135m",
    "yi-34b": "yi_34b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCHS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get(arch: str) -> ModelConfig:
    return _mod(arch).config()


def smoke(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
