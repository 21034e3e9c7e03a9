"""DeepSeek-V2-Lite (16B, 2.4B active) — MLA + fine-grained MoE
[arXiv:2405.04434; hf].

MLA: kv_lora_rank=512, per-head (nope=128, rope=64), v=128 — the cache
holds only the 512-d latent + shared 64-d rotary key. MoE: 64 routed
experts, top-6, 2 shared experts, d_expert=1408. Layer 0 is a dense MLP
(first_k_dense_replace=1). The same config as the JAX package's.
"""
from repro_torch.configs.base import (ArchConfig, BlockSpec, EarlyExitConfig,
                                      MLAConfig, MoEConfig, register_arch)


@register_arch
def deepseek_v2_lite_16b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,          # the dense-replace layer's MLP
        vocab_size=102400,
        head_dim=192,        # qk_nope(128) + qk_rope(64)
        block_pattern=(BlockSpec("attn", "moe"),),
        first_k_dense=1,
        rope="none",         # rotary lives inside MLA (w_kr path)
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                      num_shared_experts=2, d_shared_expert=2816),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        early_exit=EarlyExitConfig(exit_layers=(7,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
