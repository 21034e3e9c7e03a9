"""Mistral-Large-Instruct-2407 (123B) — dense GQA, 96 query heads over 8
KV heads (a group of 12) [hf:mistralai/Mistral-Large-Instruct-2407;
unverified]. The config is the full 88 layers; one 80 GB card holds 24 of
them (``chip_smoke.py`` cuts the depth with ``dataclasses.replace``).
"""
from repro_torch.configs.base import ArchConfig, EarlyExitConfig, register_arch


@register_arch
def mistral_large_123b() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b",
        family="dense",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=32768,
        rope="full",
        rope_theta=1_000_000.0,
        early_exit=EarlyExitConfig(exit_layers=(22,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
