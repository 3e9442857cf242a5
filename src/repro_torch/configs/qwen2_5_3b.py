"""qwen2.5-3b — dense, 36L, GQA 16H/2KV, QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B (3B sibling card)",
)
