"""mamba2-2.7b — attention-free SSM (SSD), 64L, d=2560, state=128. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,                # no separate FFN: the Mamba2 block is the whole layer
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, chunk_size=256),
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2 2.7B)",
)
