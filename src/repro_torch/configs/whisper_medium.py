"""whisper-medium — enc-dec audio model; conv/mel frontend is a STUB.

The transformer backbone only: 24 encoder + 24 decoder layers, d=1024, 16H
(MHA: kv=16), d_ff=4096, learned positions, GELU. ``input_specs`` supplies
precomputed 1500-frame embeddings in place of the mel+conv frontend.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="encdec",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    encoder_seq=1500,        # 30s audio → 1500 frames after conv frontend (stubbed)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    act="gelu",
    norm="layernorm",
    learned_pos_emb=4096,    # learned absolute positions (decoder side)
    rope_theta=0.0,
    tie_embeddings=True,
    source="arXiv:2212.04356 (Whisper medium)",
)
