"""xLSTM-350M — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

xLSTM[7:1]: one sLSTM block per 8 (the last of each super-block), the
rest mLSTM; 24 layers, d_model 1024, 4 heads (mLSTM d_in 2048, head dim
512; sLSTM head dim 256 and a gated FFN of 1365). No generic channel mixer
(``ffn = "none"``): the xLSTM blocks carry their own projections. Early
exit after the first super-block (layer 8). The same config as the JAX
package's.
"""
from repro_torch.configs.base import (ArchConfig, BlockSpec, EarlyExitConfig,
                                      XLSTMConfig, register_arch)

_PATTERN = tuple(
    BlockSpec("slstm" if i == 7 else "mlstm", "none") for i in range(8)
)


@register_arch
def xlstm_350m() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=_PATTERN,
        rope="none",
        xlstm=XLSTMConfig(),
        early_exit=EarlyExitConfig(exit_layers=(8,), loss_weight=0.1,
                                   entropy_threshold=0.45),
    )
