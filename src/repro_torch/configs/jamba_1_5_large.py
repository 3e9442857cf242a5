"""jamba-1.5-large-398b — hybrid Mamba+attention (1:7) with MoE 16e top-2.

72L, d=8192, 64H/8KV attention at 1 of every 8 layers; MoE FFN every other
layer (16 experts, top-2, d_ff=24576). [arXiv:2403.19887]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    hybrid_period=8,
    hybrid_attn_index=4,
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff=24_576,
                  every_k_layers=2, impl="alltoall"),  # §Perf: EP all-to-all
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    rope_theta=0.0,          # Jamba attention layers use no positional encoding
    norm="rmsnorm",
    source="arXiv:2403.19887 (Jamba-1.5-Large)",
)
