"""Qwen3-30B-A3B — 128-expert top-8 MoE, QK-norm, head_dim=128
[hf:Qwen/Qwen3-30B-A3B; hf]. Every layer is MoE (no shared experts,
no dense-replace); d_expert=768 (the assignment's d_ff).
"""
from repro_torch.configs.base import (ArchConfig, BlockSpec, EarlyExitConfig,
                                      MoEConfig, register_arch)


@register_arch
def qwen3_moe_30b_a3b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=768,
        vocab_size=151936,
        head_dim=128,
        block_pattern=(BlockSpec("attn", "moe"),),
        rope="full",
        rope_theta=1_000_000.0,
        qk_norm=True,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=768),
        early_exit=EarlyExitConfig(exit_layers=(12,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
