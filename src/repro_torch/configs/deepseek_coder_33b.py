"""deepseek-coder-33b — dense llama-arch, 62L, GQA 56H/8KV. [arXiv:2401.14196]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19_200,
    vocab_size=32_256,
    rope_theta=100_000.0,
    act="silu",
    norm="rmsnorm",
    source="arXiv:2401.14196 (DeepSeek-Coder 33B)",
)
