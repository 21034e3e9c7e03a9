"""Yi-9B — dense llama-architecture GQA [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ArchConfig, EarlyExitConfig, register_arch


@register_arch
def yi_9b() -> ArchConfig:
    return ArchConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope="full",
        rope_theta=10_000.0,
        early_exit=EarlyExitConfig(exit_layers=(12,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
