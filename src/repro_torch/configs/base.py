"""Model / run configuration dataclasses — the port's own copy of the JAX
package's ``configs/base.py``, field for field (the tests compare the two).

Every assigned architecture is expressed as a ``ModelConfig``; the model in
``repro_torch.models.model`` reads ``arch_type``. Configs are plain
frozen dataclasses so they hash, print, and diff cleanly — no framework magic.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int = 0
    experts_per_token: int = 0
    d_ff: int = 0                  # per-expert hidden dim
    num_shared_experts: int = 0    # always-on experts (DeepSeek/Kimi style)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01  # load-balance loss weight
    every_k_layers: int = 1        # MoE FFN on layers where (i % k == k-1)
    impl: str = "gather"           # "gather" (pjit) | "alltoall" (shard_map EP)
    route_groups: int = 0          # >0: DeepSeek/K2-style node-limited routing —
                                   # each token may only use experts from its
                                   # top-G data shards; dispatch dedups to one
                                   # send per (token, group) (§Perf)

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD — state space duality) block configuration."""

    d_state: int = 0
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def enabled(self) -> bool:
        return self.d_state > 0

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture card.

    ``arch_type`` ∈ {dense, moe, ssm, hybrid, encdec, vlm}. ``source`` cites
    the paper / model card the numbers come from.
    """

    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""

    head_dim: int = 0                   # 0 → d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0             # 0 → full attention
    norm_eps: float = 1e-6
    act: str = "silu"                   # silu (SwiGLU) | gelu (plain MLP)
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    tie_embeddings: bool = False
    learned_pos_emb: int = 0            # >0 → learned absolute positions (whisper)

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # hybrid (jamba): within each period of ``hybrid_period`` layers, the layer
    # at index ``hybrid_attn_index`` is attention, the rest are Mamba2.
    hybrid_period: int = 0
    hybrid_attn_index: int = 4

    # encoder-decoder (whisper): encoder consumes stubbed frame embeddings.
    encoder_layers: int = 0
    encoder_seq: int = 0

    # VLM: stubbed vision frontend supplies ``num_patches`` patch embeddings
    # that are prepended to the token embeddings.
    num_patches: int = 0

    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    # "full" recomputes the whole layer in bwd; "dots" saves matmul outputs
    # (skips re-running the tensor-parallel collectives during recompute —
    # §Perf iteration 3)
    remat_policy: str = "full"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived sizes ------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the vocab axis shards
        evenly over the 16-way 'model' mesh axis (MaxText-style padding).
        Padded rows are never produced by the tokenizer; their logits are
        valid softmax entries that simply never win."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.arch_type == "ssm":
            return False
        if self.hybrid_period:
            return (i % self.hybrid_period) == self.hybrid_attn_index
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe.enabled:
            return False
        k = self.moe.every_k_layers
        return (i % k) == (k - 1)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # input embedding
        if not self.tie_embeddings:
            n += v * d
        for i in range(self.num_layers):
            if self.is_attn_layer(i):
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            elif self.ssm.enabled:
                di = self.ssm.d_inner(d)
                nh = self.ssm.num_heads(d)
                g, s = self.ssm.n_groups, self.ssm.d_state
                n += d * (2 * di + 2 * g * s + nh)       # in_proj
                n += di * d                              # out_proj
                n += (di + 2 * g * s) * self.ssm.conv_width + 2 * nh + di
            if self.is_moe_layer(i):
                e = self.moe.num_experts + self.moe.num_shared_experts
                n += e * 3 * d * self.moe.d_ff + d * self.moe.num_experts
            elif self.d_ff:
                mult = 3 if self.act == "silu" else 2
                n += mult * d * self.d_ff
        for _ in range(self.encoder_layers):
            n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            mult = 3 if self.act == "silu" else 2
            n += mult * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.moe.enabled:
            return self.param_count()
        full = self.param_count()
        e_all = self.moe.num_experts + self.moe.num_shared_experts
        e_act = self.moe.experts_per_token + self.moe.num_shared_experts
        per_expert = 3 * self.d_model * self.moe.d_ff
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        return full - n_moe_layers * (e_all - e_act) * per_expert

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training-step hyperparameters (used by launch/train.py and dryrun)."""

    global_batch: int = 256
    seq_len: int = 4096
    microbatches: int = 1             # gradient-accumulation steps
    ce_chunk: int = 0                 # 0 → whole-sequence logits; else chunked CE
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0
    z_loss: float = 0.0
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer HBM (§Perf)


@dataclass(frozen=True)
class ServeConfig:
    """Decode / prefill step configuration."""

    batch: int = 128
    cache_len: int = 32_768
    prefill_chunk: int = 0


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned (shape-id → workload) rows."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

INPUT_SHAPE_BY_NAME = {s.name: s for s in INPUT_SHAPES}
