"""mixtral-8x22b — MoE 8 experts top-2, GQA 48H/8KV, sliding-window attention.

56L, d=6144, per-expert d_ff=16384, vocab=32768, SWA window 4096 — the SWA is
what qualifies this card for the long_500k decode shape. [arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32_768,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff=16_384),
    rope_theta=1_000_000.0,
    act="silu",
    norm="rmsnorm",
    source="arXiv:2401.04088 (Mixtral 8x22B)",
)
