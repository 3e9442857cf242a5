"""starcoder2-15b — dense code model, 40L, GQA 48H/4KV, RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=100_000.0,
    qkv_bias=True,           # StarCoder2 uses bias on attention/MLP projections
    act="gelu",
    norm="layernorm",
    source="arXiv:2402.19173 (StarCoder2-15B)",
)
