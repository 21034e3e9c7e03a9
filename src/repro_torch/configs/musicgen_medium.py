"""MusicGen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf]. The EnCodec / codebook frontend is a stub: it
provides precomputed frame embeddings [B, T, d] (``frontend_stub=True``),
which the backbone takes directly; the 2048-entry codebook vocabulary is
the output space. Absolute (sinusoidal) positions live in the stubbed
frontend, so ``rope="none"``. 24 query heads over 24 KV heads of 64.
"""
from repro_torch.configs.base import ArchConfig, EarlyExitConfig, register_arch


@register_arch
def musicgen_medium() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        rope="none",
        frontend_stub=True,
        early_exit=EarlyExitConfig(exit_layers=(12,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
