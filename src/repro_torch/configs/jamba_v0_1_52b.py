"""Jamba v0.1 52B — hybrid Mamba + attention MoE [arXiv:2403.19887; hf].

32 layers, attention every 8th layer (attn_layer_offset=4, period=8) and
MoE every other layer (expert_layer_offset=1, period=2): per 8-layer
super-block the mixers are M M M M A M M M and the odd layers carry the
16-expert top-2 MoE. No positional embedding (the Mamba layers carry
position). Early exit after the first super-block (layer 8). The same
config as the JAX package's; a cut depth is
``dataclasses.replace(cfg, num_layers=16)`` (two super-blocks).
"""
from repro_torch.configs.base import (ArchConfig, BlockSpec, EarlyExitConfig,
                                      MambaConfig, MoEConfig, register_arch)

_PATTERN = tuple(
    BlockSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)


@register_arch
def jamba_v0_1_52b() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        block_pattern=_PATTERN,
        rope="none",
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        early_exit=EarlyExitConfig(exit_layers=(8,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
