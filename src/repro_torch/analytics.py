"""Analytic FLOP / byte / collective counts per (arch x shape) cell, and
the three-term roofline.

Counterpart of ``repro.analytics``.  The counts are arithmetic on a config
and depend on no hardware: ``forward_flops`` (a forward pass's FLOPs, its
linear layers, attention or recurrence context and LM head), ``cell_cost``
(per-device FLOPs, device-memory bytes, link and inter-node bytes and
model FLOPs of one step of a cell; ``model_flops`` counts ``6 N_active``
per trained token, ``2 N_active`` per served one) and ``_cache_bytes``.
The mesh of ``cell_cost`` is ``repro``'s: ``pods x 16 x 16`` devices
(data, tensor); ``model_flops`` depends only on ``chips``.

``roofline`` divides a cost by a hardware entry.  The port defines one,
``H100_SXM``, with public numbers; ``chip_smoke.py``'s bounds take their
peak and memory rate from it.
"""
from __future__ import annotations

import dataclasses

from .configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-device rates: ``peak_flops`` dense bf16 FLOP/s, ``hbm_bw``
    device-memory bytes/s, ``link_bw`` egress bytes/s to the devices of
    its node, ``dcn_bw`` bytes/s to other nodes."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    dcn_bw: float


H100_SXM = Hardware(
    name="NVIDIA H100 SXM5 80GB",
    # NVIDIA H100 Tensor Core GPU datasheet, SXM column: 989 TFLOP/s dense
    # bf16 (1,979 with sparsity), 3.35 TB/s HBM3, at the 700 W limit
    peak_flops=989e12,
    hbm_bw=3.35e12,
    # same datasheet: NVLink 900 GB/s a GPU, both directions together
    link_bw=450e9,
    # NVIDIA DGX H100 datasheet: 8 ConnectX-7 400 Gb/s InfiniBand ports,
    # one a GPU
    dcn_bw=50e9,
)


@dataclasses.dataclass(frozen=True)
class CellCost:
    """All quantities are PER-CHIP per step unless suffixed otherwise."""
    flops: float                 # compiled-work FLOPs / chip (incl. remat)
    hbm_bytes: float             # HBM traffic / chip
    ici_bytes: float             # link egress / chip (within a node)
    dcn_bytes: float             # inter-node egress / chip (pod axis)
    model_flops: float           # useful: 6*N_active*D (train), 2*N_active/tok (serve) / chip
    params_bytes: float          # global parameter bytes (bf16)
    notes: str = ""


def _block_linear_flops(cfg: ModelConfig, kind: str) -> float:
    """Forward MAC*2 FLOPs per token in one block's linear layers."""
    d, hd = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.q_dim, cfg.kv_dim
    mlp_mats = 2 if cfg.mlp_variant == "gelu" else 3
    if kind in ("attn", "local_attn"):
        lin = d * qd + 2 * d * kvd + qd * d
        lin += mlp_mats * d * cfg.d_ff
    elif kind == "moe":
        lin = d * qd + 2 * d * kvd + qd * d
        lin += d * cfg.n_experts + cfg.top_k * mlp_mats * d * cfg.d_ff
    elif kind == "rglru":
        w = cfg.lru_width
        lin = 2 * d * w + cfg.conv_width * w + w * d
        lin += (2 if cfg.mlp_variant == "gelu" else 3) * d * cfg.d_ff
    elif kind == "mlstm":
        inner = 2 * d
        lin = 2 * d * inner + 3 * inner * (inner // cfg.n_heads) \
            + inner * d + 2 * inner * cfg.n_heads
    elif kind == "slstm":
        lin = 8 * d * d + d * d
    else:
        raise ValueError(kind)
    return 2.0 * lin


def _attn_ctx_flops(cfg: ModelConfig, kind: str, S: int, ctx: int) -> float:
    """Attention/recurrence context FLOPs per SEQUENCE (not per token)."""
    hd, H = cfg.head_dim, cfg.n_heads
    if kind in ("attn", "moe"):
        # causal: ~S*ctx/2 scores when ctx == S; S*ctx when decoding (S=1)
        pairs = S * ctx / 2 if S == ctx else S * ctx
        return 2.0 * 2.0 * pairs * H * hd          # QK^T + PV
    if kind == "local_attn":
        w = min(cfg.window or ctx, ctx)
        pairs = S * min(w, ctx) if S == 1 else S * w
        return 2.0 * 2.0 * pairs * H * hd
    if kind == "rglru":
        return 8.0 * S * cfg.lru_width              # gates + scan
    if kind == "mlstm":
        dh = (2 * cfg.d_model) // H
        # chunkwise: intra-chunk quadratic + state update O(dh^2)
        c = min(cfg.mlstm_chunk, S)
        intra = 2.0 * 2.0 * S * c / 2 * H * dh
        state = 2.0 * 2.0 * S * H * dh * dh
        return intra + state
    if kind == "slstm":
        return 16.0 * S * cfg.d_model
    return 0.0


def _layer_kinds(cfg: ModelConfig):
    period = cfg.block_pattern
    return [period[i % len(period)] for i in range(cfg.n_layers)]


def forward_flops(cfg: ModelConfig, B: int, S: int, ctx: int) -> float:
    """Forward pass FLOPs for B sequences of S new tokens vs ctx context."""
    tok = B * S
    total = 0.0
    for kind in _layer_kinds(cfg):
        total += tok * _block_linear_flops(cfg, kind)
        total += B * _attn_ctx_flops(cfg, kind, S, ctx)
    total += 2.0 * tok * cfg.d_model * cfg.vocab_size   # lm head
    return total


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, *, chips: int,
              pods: int = 1, rules: str = "fsdp",
              dtype_bytes: int = 2) -> CellCost:
    """Per-chip analytic cost model for one step of a cell.

    Mesh model: chips = pods x data_par x tp; batch sharded over
    (pod, data), weights 2-D sharded (contraction over data = FSDP, feature
    over tp) under the fsdp rule set, TP-only under baseline.
    """
    B, S = shape.global_batch, shape.seq_len
    data_par, tp = 16, 16
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    params_bytes = n_params * dtype_bytes
    d = cfg.d_model

    if shape.kind == "train":
        tok_local = B * S / (pods * data_par)   # tokens per chip column
        fwd_flops_tok = forward_flops(cfg, B, S, S) / (B * S)
        fwd = fwd_flops_tok * tok_local / tp
        flops = (4.0 if cfg.remat else 3.0) * fwd
        model_flops = 6.0 * n_active * (B * S) / chips
        # -- HBM / chip: weight shards (fwd+bwd+update reads, update write),
        # optimizer m/v read+write (f32), grads (f32 rw), saved residuals,
        # per-layer activation traffic (fwd+bwd, read+write), logits xent.
        w_local = n_params / (data_par * tp if rules == "fsdp" else tp) * 4
        opt_local = 2 * n_params / (data_par * tp) * 4
        act_layer = 8.0 * tok_local * d * dtype_bytes      # ~8 tensors/layer
        hbm = (4 * w_local + 4 * opt_local
               + 2 * cfg.n_layers * 2 * act_layer
               + 2 * tok_local * cfg.vocab_size / tp * 4)
        # -- ICI / chip:
        #   FSDP: all-gather weights (fwd + bwd recompute) + reduce-scatter
        #   grads, each moving ~the model-shard's bytes through every chip
        w_shard_bf16 = n_params * dtype_bytes / tp
        fsdp_traffic = (2 * w_shard_bf16 + n_params * 4 / tp) \
            if rules == "fsdp" else 2 * n_params * 4 / tp
        #   TP: 2 collectives/layer over the residual stream (fwd) + same in
        #   bwd; seq-parallel turns all-reduce into rs+ag of equal volume
        tp_traffic = 4.0 * cfg.n_layers * tok_local * d * dtype_bytes
        ici = fsdp_traffic + tp_traffic
        # -- DCN / chip: cross-pod grad all-reduce of this chip's grad shard
        dcn = (2.0 * (pods - 1) / pods) * n_params * 4 / (data_par * tp) \
            if pods > 1 else 0.0
        note = (f"accum-agnostic per-step totals; weights 6N={6*n_active/1e9:.0f}G "
                f"useful flops global")
    else:
        new_tok = B * (S if shape.kind == "prefill" else 1)
        batch_shards = min(B, pods * data_par)
        tok_local = new_tok / batch_shards
        fwd_flops_tok = forward_flops(
            cfg, B, S if shape.kind == "prefill" else 1, S) / new_tok
        flops = fwd_flops_tok * tok_local / tp
        model_flops = 2.0 * n_active * new_tok / chips
        cache_local = _cache_bytes(cfg, B, S, dtype_bytes) \
            / (batch_shards * (tp if shape.kind != "prefill" else 1))
        w_local = params_bytes / tp / (data_par if rules == "fsdp" else 1)
        hbm = w_local + cache_local * (2 if shape.kind == "prefill" else 1) \
            + 4.0 * tok_local * d * dtype_bytes * cfg.n_layers / tp
        if rules == "fsdp":
            ici_w = 2 * params_bytes / tp  # gather the FSDP shards
        else:
            ici_w = 0.0
        tp_traffic = 2.0 * cfg.n_layers * tok_local * d * dtype_bytes
        ici = ici_w + tp_traffic
        dcn = 0.0
        note = (f"{shape.kind}: cache "
                f"{_cache_bytes(cfg, B, S, dtype_bytes)/1e9:.1f} GB global")

    return CellCost(flops=flops, hbm_bytes=hbm, ici_bytes=ici, dcn_bytes=dcn,
                    model_flops=model_flops, params_bytes=params_bytes,
                    notes=note)


def _cache_bytes(cfg: ModelConfig, B: int, S: int, dtype_bytes: int) -> float:
    total = 0.0
    for kind in _layer_kinds(cfg):
        if kind in ("attn", "moe"):
            total += 2 * B * S * cfg.kv_dim * dtype_bytes
        elif kind == "local_attn":
            total += 2 * B * min(S, cfg.window or S) * cfg.kv_dim * dtype_bytes
        elif kind == "rglru":
            total += B * cfg.lru_width * (4 + (cfg.conv_width - 1) * dtype_bytes)
        elif kind == "mlstm":
            dh = 2 * cfg.d_model // cfg.n_heads
            total += B * cfg.n_heads * (dh * dh + dh + 1) * 4
        elif kind == "slstm":
            total += 4 * B * cfg.d_model * 4
    return total


def roofline(cost: CellCost, *, chips: int,
             hw: Hardware = H100_SXM) -> dict:
    """Three-term roofline from PER-CHIP costs on ``hw``.
    ``roofline_fraction`` is useful-compute time over the binding term: the
    fraction of the step the tensor cores would spend on model FLOPs if
    everything else were perfectly overlapped (an MFU-style upper
    bound)."""
    t_compute = cost.flops / hw.peak_flops
    t_memory = cost.hbm_bytes / hw.hbm_bw
    t_coll = cost.ici_bytes / hw.link_bw + cost.dcn_bytes / hw.dcn_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    t_useful = cost.model_flops / hw.peak_flops
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "dominant": dom,
        "step_time_est": bound,
        "roofline_fraction": t_useful / bound if bound > 0 else 0.0,
        "model_flops_ratio": cost.model_flops / max(cost.flops, 1.0),
    }
