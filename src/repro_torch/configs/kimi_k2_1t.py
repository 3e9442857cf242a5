"""kimi-k2-1t-a32b — trillion-param MoE: 61L, d=7168, 384 experts top-8.

Per the assignment card: GQA 64H/8KV, per-expert d_ff=2048, vocab=163840,
1 shared expert (DeepSeek-V3-style), 32B active parameters. [arXiv:2501.kimi2]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,            # 7168 / 64
    d_ff=0,                  # all FFNs are MoE
    vocab_size=163_840,
    moe=MoEConfig(num_experts=384, experts_per_token=8, d_ff=2048,
                  num_shared_experts=1,
                  # production layout (§Perf): shard_map expert-parallel
                  # all-to-all + K2's node-limited routing (4 groups)
                  impl="alltoall", route_groups=4),
    rope_theta=50_000.0,
    act="silu",
    norm="rmsnorm",
    source="arXiv:2501.kimi2 (Kimi K2 paper-table)",
)
