"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.

The vision encoder + projector are stubbed per the assignment: ``input_specs``
supplies precomputed patch embeddings (num_patches × d_model) which the LM
prepends to token embeddings. Backbone: 48L, d=6144, GQA 48H/8KV.
[arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    num_patches=256,         # one image tile → 256 visual tokens after projector
    rope_theta=1_000_000.0,
    act="silu",
    norm="rmsnorm",
    source="arXiv:2404.16821 (InternVL2-26B, InternLM2 backbone)",
)
