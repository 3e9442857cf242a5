"""qwen3-0.6b — dense, 28L, GQA 16H/8KV, qk_norm. [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,          # Qwen3 uses head_dim 128 independent of d_model
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B (0.6B sibling card)",
)
