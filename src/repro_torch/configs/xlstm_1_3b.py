"""xlstm-1.3b [ssm]: 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304 - sLSTM +
mLSTM blocks, xLSTM[7:1] layout (7 mLSTM : 1 sLSTM per period).
[arXiv:2405.04517]

Fully recurrent (O(1) state) => runs the long_500k cell.  d_ff=0: mLSTM
blocks carry their own 2x up/down projection instead of a separate FFN.
"""
import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="xlstm", n_layers=48, d_model=2048,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
        block_pattern=("mlstm",) * 7 + ("slstm",), pos_type="none",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="xlstm-1.3b-smoke", n_layers=4, d_model=32,
        n_heads=2, n_kv_heads=2, vocab_size=256, head_dim=0,
        block_pattern=("mlstm", "slstm"), mlstm_chunk=16)
