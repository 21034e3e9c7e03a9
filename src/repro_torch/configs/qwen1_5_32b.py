"""Qwen1.5-32B — dense MHA (kv=40 == heads) with QKV bias
[hf:Qwen/Qwen1.5-0.5B family; hf].
"""
from repro_torch.configs.base import ArchConfig, EarlyExitConfig, register_arch


@register_arch
def qwen1_5_32b() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        rope="full",
        rope_theta=1_000_000.0,
        qkv_bias=True,
        early_exit=EarlyExitConfig(exit_layers=(16,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
