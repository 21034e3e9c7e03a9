"""ChatGLM3-6B — dense GQA (kv=2), 2d/partial RoPE, QKV bias
[arXiv:2406.12793; hf]. GLM applies rotary to half the head dims.
"""
from repro_torch.configs.base import ArchConfig, EarlyExitConfig, register_arch


@register_arch
def chatglm3_6b() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rope="partial",
        rope_partial_pct=0.5,
        qkv_bias=True,
        early_exit=EarlyExitConfig(exit_layers=(7,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
