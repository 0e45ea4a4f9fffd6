"""The yardstick: the card's peaks and the operations and bytes that each
unit of work needs, counted from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates (the numbers of
``repro_torch.analytics.H100_SXM``, copied so that the program cannot move
them): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.  They
assume the card's full 700 W; the run prints the card's power limit.

Model FLOPs count the products a step needs, not what a kernel issues:
2 a weight a token forward, 6 in training (forward and two backward
products); attention 4 D a visible query-key pair a head forward (Q K^T
and P V), 12 D in training.  Remat's recomputation is not counted.
``flash_*_bound_s`` give a kernel's least time, the larger of its
operations at the bf16 peak and each input byte read once and each output
byte written once at the memory rate (``chip_smoke.py::with_bound`` and
``flash_pair_times``'s counts).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12         # HBM3


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def matmul_params(dm) -> int:
    """Weights of every product a token runs, as the configuration's
    reference module counts them (``Dims.token_matmul_params``)."""
    return dm.token_matmul_params()


def train_step_flops(dm, B: int, S: int) -> float:
    """6 N a token plus 12 D a causal pair, each head and layer
    (``chip_smoke.py::train_model_flops`` for a dense model)."""
    attn = (12 * dm.head_dim * causal_pairs(S) * dm.heads
            * dm.attention_layers * B)
    return 6 * matmul_params(dm) * B * S + attn


def prefill_flops(dm, B: int, S: int) -> float:
    """2 N a token through the layers, 4 D a causal pair, each head and
    layer, and the last position's unembedding."""
    layers = matmul_params(dm) - dm.d * dm.vocab
    attn = (4 * dm.head_dim * causal_pairs(S) * dm.heads
            * dm.attention_layers * B)
    return 2 * layers * B * S + attn + 2 * dm.d * dm.vocab * B


def decode_step_flops(dm, B: int, context: int) -> float:
    """One token a row against ``context`` cached positions (itself
    included), and its unembedding."""
    attn = (4 * dm.head_dim * context * dm.heads * dm.attention_layers
            * B)
    return 2 * matmul_params(dm) * B + attn


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def flash_fwd_bound_s(B, S, H, KV, D, elt=2, lse=False) -> float:
    ops = 4 * D * causal_pairs(S) * B * H
    nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * elt
    return bound_s(ops, nbytes + (4 * B * S * H if lse else 0))


def flash_bwd_bound_s(B, S, H, KV, D, elt=2) -> float:
    """Reads q, k, v, out, dout, lse; writes dq, dk, dv."""
    ops = 10 * D * causal_pairs(S) * B * H
    nbytes = (4 * B * S * H * D + 4 * B * S * KV * D) * elt + 4 * B * S * H
    return bound_s(ops, nbytes)


def decode_attn_bound_s(B, H, KV, D, context, elt=2) -> float:
    """Reads ``context`` cached keys and values and q, writes out."""
    ops = 4 * D * context * B * H
    nbytes = (2 * B * context * KV * D + 2 * B * H * D) * elt + 4 * B
    return bound_s(ops, nbytes)
