"""Chameleon-34B — early-fusion mixed-modal transformer
[arXiv:2405.09818; unverified]. The VQ-VAE image tokenizer is a stub: it
provides mixed-modal token embeddings [B, T, d] (``frontend_stub=True``);
the 65536 vocab covers text + VQ image codes. Chameleon's QK-norm is on —
it is what made the 34B trainable.
"""
from repro_torch.configs.base import ArchConfig, EarlyExitConfig, register_arch


@register_arch
def chameleon_34b() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        rope="full",
        qk_norm=True,
        frontend_stub=True,
        early_exit=EarlyExitConfig(exit_layers=(12,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
