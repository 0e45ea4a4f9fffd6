"""Model/run configuration.

One frozen dataclass describes an architecture; ``src/repro/configs/<id>.py``
files instantiate the 10 assigned architectures (plus reduced smoke variants)
and register them in ``repro.configs.registry``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid_rglru | xlstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # positions
    pos_type: str = "rope"         # rope | mrope | learned | none
    rope_theta: float = 10000.0
    mrope_sections: Sequence[int] = ()   # qwen2-vl t/h/w split of head_dim/2

    # block pattern (period definition); () -> ("attn",) * 1
    # kinds: attn | local_attn | rglru | mlstm | slstm | moe
    block_pattern: Sequence[str] = ()
    window: int = 0                # local attention window
    lru_width: int = 0             # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4            # temporal conv in recurrent blocks
    mlstm_chunk: int = 256         # chunk size of the chunkwise mLSTM form

    # modality frontend stub: inputs are precomputed embeddings, not tokens
    embeds_input: bool = False

    # biases of the q, k and v projections (Qwen2; the output has none)
    qkv_bias: bool = False

    # Qwen2-VL's vision tower (``models/vision.py``), off at 0 layers:
    # pre-LayerNorm blocks of ``vision_d`` with ``vision_heads`` heads, a
    # fused qkv with its bias, 2-D rotary positions and a QuickGELU MLP of
    # ``vision_ff`` (LayerNorm eps and rotary theta are Qwen2-VL's
    # constants there); patches of ``vision_patch_dim`` inputs (channels x
    # frames x pixels of a patch); ``vision_merge`` x ``vision_merge``
    # patches merged into one cell of d_model, which takes the place of an
    # ``image_token_id`` in the text
    vision_layers: int = 0
    vision_d: int = 0
    vision_heads: int = 0
    vision_ff: int = 0
    vision_patch_dim: int = 0
    vision_merge: int = 0
    image_token_id: int = -1

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mlp_variant: str = "swiglu"    # swiglu (3-matrix) | gelu (2-matrix)

    # numerics / compilation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attention_impl: str = "auto"   # auto | ref | xla_flash | pallas

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.block_pattern:
            kind = "moe" if self.family == "moe" else "attn"
            object.__setattr__(self, "block_pattern", (kind,))
        object.__setattr__(self, "block_pattern", tuple(self.block_pattern))
        object.__setattr__(self, "mrope_sections", tuple(self.mrope_sections))
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        assert self.n_heads % self.n_kv_heads == 0, "GQA group must divide heads"

    # -- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_groups(self) -> int:
        """Number of full pattern periods (scanned)."""
        return self.n_layers // len(self.block_pattern)

    @property
    def n_tail(self) -> int:
        """Layers after the last full period (executed unscanned)."""
        return self.n_layers % len(self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if no block attends over unbounded full context ("moe"
        blocks carry full attention too; "local_attn" is windowed)."""
        return "attn" not in self.block_pattern and \
            "moe" not in self.block_pattern

    def param_count(self) -> int:
        """Exact parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += d * v                 # lm head
        total += d                         # final norm
        per_kind = {}
        for kind in set(self.block_pattern):
            per_kind[kind] = self._block_params(kind)
        for i in range(self.n_layers):
            total += per_kind[self.block_pattern[i % len(self.block_pattern)]]
        return total + self.vision_param_count()

    def vision_param_count(self) -> int:
        """The tower's parameters: the patch embedding (no bias), the
        blocks (two LayerNorms, qkv and its bias, the output projection
        and the MLP with their biases) and the merger (a LayerNorm, two
        matrices with their biases); 0 without a tower."""
        if not self.vision_layers:
            return 0
        vd, f, m = self.vision_d, self.vision_ff, self.vision_merge ** 2
        block = (4 * vd + 3 * vd * vd + 3 * vd + vd * vd + vd
                 + 2 * vd * f + f + vd)
        merger = 2 * vd + (m * vd) ** 2 + m * vd + m * vd * self.d_model \
            + self.d_model
        return (self.vision_patch_dim * vd + self.vision_layers * block
                + merger)

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        expert = 3 * d * self.d_ff
        dense = self.param_count() - self.n_layers * self.n_experts * expert
        return dense + self.n_layers * self.top_k * expert

    def _block_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        qd, kvd = self.q_dim, self.kv_dim
        norm = d
        mlp_mats = 2 if self.mlp_variant == "gelu" else 3
        if kind in ("attn", "local_attn"):
            attn = d * qd + 2 * d * kvd + qd * d
            if self.qkv_bias:
                attn += qd + 2 * kvd
            mlp = mlp_mats * d * self.d_ff if self.d_ff else 0
            return attn + mlp + 2 * norm
        if kind == "moe":
            attn = d * qd + 2 * d * kvd + qd * d
            router = d * self.n_experts
            experts = self.n_experts * 3 * d * self.d_ff
            return attn + router + experts + 2 * norm
        if kind == "rglru":
            w = self.lru_width
            # in-proj (2 branches) + conv + gate vectors (w_a,b_a,w_i,b_i,lam)
            # + out-proj + mlp + norms
            rec = 2 * d * w + self.conv_width * w + 5 * w + w * d
            mlp = mlp_mats * d * self.d_ff if self.d_ff else 0
            return rec + mlp + 2 * norm
        if kind == "mlstm":
            inner = 2 * d
            up = 2 * d * inner          # up-proj (value + gate branches)
            # block-diagonal per-head q,k,v (the xLSTM implementation choice)
            qkv = 3 * inner * (inner // self.n_heads)
            gates = 2 * (inner * self.n_heads + self.n_heads)
            down = inner * d
            return up + qkv + gates + down + norm
        if kind == "slstm":
            gates = 4 * d * d + 4 * d * d + 4 * d   # w_in, w_rec, bias
            down = d * d
            return gates + down + norm
        raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assigned grid."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-run substrate settings (optimizer/schedule/fault-tolerance)."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    # microbatched gradient accumulation (scan over global-batch slices);
    # bounds activation peak memory at fixed global batch
    grad_accum: int = 1
    # preemption-aware checkpointing (the paper's policies)
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_policy: str = "dp"        # dp | young_daly | fixed | none
    ckpt_cost_hours: float = 1.0 / 60.0
    step_time_hours: float = 1.0 / 3600.0   # measured online; this is the seed
    vm_type: str = "tpu-v5e-pod"
    async_checkpoint: bool = True
