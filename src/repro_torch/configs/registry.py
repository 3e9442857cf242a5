"""Architecture registry: ``--arch <id>`` → ModelConfig, plus reduced variants.

``get_config(arch_id)`` returns the full assigned card. ``reduced(cfg)``
returns the smoke-test variant of the same family (≤2 layers, d_model ≤ 512,
≤4 experts) used by CPU tests; the full cards are only ever lowered abstractly
via the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig

from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3_0_6B
from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.jamba_1_5_large import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.deepseek_coder_33b import CONFIG as DEEPSEEK_CODER_33B
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.starcoder2_15b import CONFIG as STARCODER2_15B
from repro_torch.configs.kimi_k2_1t import CONFIG as KIMI_K2_1T
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        QWEN3_0_6B,
        WHISPER_MEDIUM,
        MAMBA2_2_7B,
        JAMBA_1_5_LARGE,
        DEEPSEEK_CODER_33B,
        QWEN2_5_3B,
        INTERNVL2_26B,
        STARCODER2_15B,
        KIMI_K2_1T,
        MIXTRAL_8X22B,
    )
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def reduced(cfg: ModelConfig, *, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims (2L, d≤512, ≤4 experts)."""
    d_model = min(cfg.d_model, 256)
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, 2))
    head_dim = max(8, d_model // heads)
    kw = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=heads if cfg.num_heads else 0,
        num_kv_heads=kv if cfg.num_kv_heads else 0,
        head_dim=head_dim if cfg.num_heads else 1,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        learned_pos_emb=min(cfg.learned_pos_emb, 512) if cfg.learned_pos_emb else 0,
    )
    if cfg.moe.enabled:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff=min(cfg.moe.d_ff, 256),
        )
    if cfg.ssm.enabled:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 32), head_dim=32, chunk_size=32
        )
    if cfg.hybrid_period:
        # keep the interleave property at 2 layers: 1 mamba + 1 attn
        kw["hybrid_period"] = 2
        kw["hybrid_attn_index"] = 1
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = min(cfg.encoder_seq, 64)
    if cfg.num_patches:
        kw["num_patches"] = min(cfg.num_patches, 16)
    return cfg.replace(**kw)
