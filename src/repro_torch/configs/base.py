"""Declarative architecture / run configuration (PyTorch port).

A copy of the JAX package's ``repro.configs.base`` dataclasses, cut to what
the port serves today: decoder-only LMs with entropy early exits, dense
(GQA + SwiGLU), DeepSeek-style (MLA + top-k MoE after dense prefix
layers), hybrid (Jamba: Mamba and attention mixers in a period-8
pattern, MLP and MoE channel mixers), recurrent (xLSTM: mLSTM and sLSTM
mixers with no channel mixer), audio (MusicGen: a dense decoder whose
frontend is a stub that hands it frame embeddings) or vlm (Chameleon: a
dense decoder over mixed-modal tokens, its image tokenizer a stub).
The port keeps its own copy so that it imports nothing of the JAX package.
``ArchConfig.reduced()`` gives the same tiny config as the JAX package, so
tests can hold one against the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class EarlyExitConfig:
    """Entropy-thresholded early exit (the paper's technique).

    ``exit_layers`` are indices of the block AFTER which an exit head is
    attached; the exit fires where the normalized entropy of the exit
    logits is strictly below ``entropy_threshold``.
    """

    exit_layers: Tuple[int, ...]
    loss_weight: float = 0.1
    entropy_threshold: float = 0.45
    share_unembed: bool = True         # CALM-style shared unembedding


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k mixture of experts (capacity-based dispatch)."""

    num_experts: int
    top_k: int
    d_expert: int                      # hidden size of each routed expert
    num_shared_experts: int = 0        # DeepSeek-style always-on experts
    d_shared_expert: int = 0           # hidden size of the shared expert(s)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01    # load-balance auxiliary loss weight
    router_dtype: str = "float32"
    # renormalize gates over the KEPT experts after capacity dropping
    # (prefill only — the dropless decode path never drops)
    renorm_kept: bool = False
    # serve decode (T == 1) dispatches each token's top-k expert GEMMs
    # through the per-token ``moe_decode`` op: no capacity, no drops
    dropless_decode: bool = True


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0               # 0 => full-rank query projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM mixer."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                    # d_inner = expand * d_model
    dt_rank: int = 0                   # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM cell parameters (mLSTM + sLSTM blocks)."""

    mlstm_proj_factor: float = 2.0     # up-projection in mLSTM blocks
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4
    chunk_size: int = 64               # chunkwise-parallel mLSTM chunk length


MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")
FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
XLSTM_MIXERS = ("mlstm", "slstm")


@dataclass(frozen=True)
class BlockSpec:
    """One layer = (sequence mixer, channel mixer). The port runs attention
    (GQA, or MLA when the arch has ``mla``), a Mamba, mLSTM or sLSTM mixer,
    with a SwiGLU MLP, an MoE or no channel mixer (``"none"``: xLSTM blocks
    carry their own projections)."""

    mixer: str
    ffn: str

    def __post_init__(self):
        if self.mixer not in MIXERS or self.ffn not in FFNS:
            raise ValueError(f"the port runs only {MIXERS} x {FFNS} blocks, "
                             f"got ({self.mixer!r}, {self.ffn!r})")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                  # 0 => d_model // num_heads
    block_pattern: Tuple[BlockSpec, ...] = (BlockSpec("attn", "mlp"),)
    first_k_dense: int = 0
    rope: str = "full"                 # full | partial | none
    rope_theta: float = 10_000.0
    rope_partial_pct: float = 0.5      # used when rope == "partial"
    qkv_bias: bool = False
    qk_norm: bool = False              # RMSNorm of q and k over the head dim
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    early_exit: Optional[EarlyExitConfig] = None
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # modality stub (audio, vlm): the frontend provides embeddings [B, T,
    # d], which the model takes in place of token ids
    frontend_stub: bool = False

    def __post_init__(self):
        hd = self.head_dim or self.d_model // self.num_heads
        object.__setattr__(self, "head_dim", hd)
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: the port serves the families "
                             f"{FAMILIES}, got {self.family!r}")
        if any(b.ffn == "moe" for b in self.block_pattern) != (
                self.moe is not None):
            raise ValueError(f"{self.name}: MoE blocks need a MoEConfig "
                             f"and a MoEConfig needs MoE blocks")
        if any(b.mixer == "mamba" for b in self.block_pattern) != (
                self.mamba is not None):
            raise ValueError(f"{self.name}: Mamba blocks need a MambaConfig "
                             f"and a MambaConfig needs Mamba blocks")
        if any(b.mixer in XLSTM_MIXERS for b in self.block_pattern) != (
                self.xlstm is not None):
            raise ValueError(f"{self.name}: xLSTM blocks need an XLSTMConfig "
                             f"and an XLSTMConfig needs xLSTM blocks")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")
        if (self.num_layers - self.first_k_dense) % len(self.block_pattern):
            raise ValueError(f"{self.name}: layers not divisible by the "
                             f"pattern period {len(self.block_pattern)}")

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_superblocks(self) -> int:
        return (self.num_layers - self.first_k_dense) // self.period

    @property
    def recurrent(self) -> bool:
        """True when a layer carries recurrent state (a Mamba, mLSTM or
        sLSTM mixer): its prefill must run at the exact prompt length, the
        paged engine keeps that state slot-indexed beside the attention
        pages (if any), and speculative decoding is refused for it."""
        return any(b.mixer != "attn" for b in self.block_pattern)

    def layer_spec(self, i: int) -> BlockSpec:
        """BlockSpec of absolute layer index i (prefix layers take the
        pattern's mixer with a dense MLP)."""
        if i < self.first_k_dense:
            return BlockSpec(self.block_pattern[i % self.period].mixer, "mlp")
        return self.block_pattern[(i - self.first_k_dense) % self.period]

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU tests (same as the JAX one)."""
        changes: dict = dict(
            num_layers=max(self.period * 2 + self.first_k_dense,
                           self.first_k_dense + self.period),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert=32,
                d_shared_expert=32 if self.moe.num_shared_experts else 0)
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16)
        if self.mamba is not None:
            changes["mamba"] = dataclasses.replace(self.mamba, d_state=8)
        if self.xlstm is not None:
            changes["xlstm"] = dataclasses.replace(self.xlstm, chunk_size=16)
        if self.early_exit is not None:
            # keep a single exit aligned to the reduced depth
            nl = changes["num_layers"]
            changes["early_exit"] = dataclasses.replace(
                self.early_exit,
                exit_layers=((self.first_k_dense + self.period,)
                             if nl > self.period else (self.period,)))
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class RunConfig:
    """An arch plus the dispatch policy its ops run under.

    ``policy`` is ``"auto"`` (hand-written kernels for CUDA tensors, plain
    PyTorch for CPU tensors), ``"ref"`` (plain PyTorch everywhere — the
    oracle that tests and ``chip_smoke.py`` hold the kernels against) or a
    ``core.xaif.Policy`` naming per-op backends (W8A8 serving:
    ``Policy({"gemm": "int8"}, allow_lossy=True)``). Weight quantization
    is not a flag here: int8 weights are a params tree that
    ``serve.quantize.quantize_weights_int8`` made."""

    arch: ArchConfig
    policy: Any = "auto"         # str or core.xaif.Policy


# ---------------------------------------------------------------------------
# Registry: each config module registers itself when imported
# ---------------------------------------------------------------------------

_ARCH_REGISTRY: dict = {}


def register_arch(fn):
    """Decorator: register a zero-arg builder returning an ArchConfig."""
    cfg = fn()
    _ARCH_REGISTRY[cfg.name] = cfg
    return fn


def _register_builtin() -> None:
    # each config module registers itself when imported
    from repro_torch.configs import chameleon_34b  # noqa: F401
    from repro_torch.configs import chatglm3_6b  # noqa: F401
    from repro_torch.configs import deepseek_v2_lite_16b  # noqa: F401
    from repro_torch.configs import jamba_v0_1_52b  # noqa: F401
    from repro_torch.configs import mistral_large_123b  # noqa: F401
    from repro_torch.configs import musicgen_medium  # noqa: F401
    from repro_torch.configs import qwen1_5_32b  # noqa: F401
    from repro_torch.configs import qwen3_moe_30b_a3b  # noqa: F401
    from repro_torch.configs import xlstm_350m  # noqa: F401
    from repro_torch.configs import yi_9b  # noqa: F401


def get_arch(name: str) -> ArchConfig:
    _register_builtin()
    try:
        return _ARCH_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_REGISTRY)}") from None


def list_archs() -> Tuple[str, ...]:
    _register_builtin()
    return tuple(sorted(_ARCH_REGISTRY))
