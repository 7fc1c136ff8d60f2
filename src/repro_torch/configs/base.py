"""Model/config system: every assigned architecture is a ModelConfig.

Counterpart of ``repro.configs.base``, copied as data.  Layer
heterogeneity (hybrid attn/ssm interleave, periodic MoE, periodic
cross-attention) is expressed as a *layer pattern* of period ``p``: the
model is ``n_layers / p`` repetitions of the pattern.  The reference stacks
each pattern slot's parameters over the repetitions and scans them; the
port holds the ``n_layers`` layers in pattern order in one
``nn.ModuleList`` (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence

# attn: causal self-attention; mamba: SSD block; cross_attn: attention over
# context embeddings (VLM injection layers); attn_cross: self-attn followed
# by cross-attn in one layer (classic enc-dec decoder, whisper).
LayerKind = Literal["attn", "mamba", "cross_attn", "attn_cross"]
FFNKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern."""

    kind: LayerKind = "attn"
    ffn: FFNKind = "dense"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # Routed-prob normalization (DeepSeek/Kimi renormalize the top-k).
    normalize_gates: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Non-causal encoder stack (whisper); frontend is a stub."""

    n_layers: int = 12
    n_frames: int = 1500  # stub conv frontend output length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_kind: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "gelu"] = "swiglu"
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None
    layer_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    n_image_tokens: int = 0  # vlm stub frontend output length
    # MiniCPM-style mup scaling knobs (1.0 = off).
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logits_divisor: float = 1.0
    # MoE dispatch implementation: "dense" (GSPMD-inferred, models/moe.py)
    # or "a2a" (explicit shard_map all-to-all EP, models/moe_a2a.py).
    moe_impl: str = "dense"
    # Training-memory knobs (per-arch defaults; overridable per run).
    grad_accum: int = 1
    remat: bool = True

    def __post_init__(self):
        if self.n_layers % len(self.layer_pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern period {len(self.layer_pattern)}"
            )

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads if self.n_heads else 0)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to %256 so the LM head shards evenly (the padded
        rows are never indexed by data and act as dead logit classes)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does not grow quadratically with context —
        the gate for the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Parameter count (used for roofline MODEL_FLOPS), from the
        parameter shapes of a ``Model`` on the meta device."""
        from repro_torch.models.model import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params

        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


LM_SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES = {s.name: s for s in LM_SHAPES}

_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE_REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def cells(arch: str) -> list[ShapeConfig]:
    """The (shape) cells this architecture runs; applies the long_500k and
    decode-applicability rules from the assignment."""
    cfg = get_config(arch)
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue  # full-attention archs skip long-context decode
        out.append(s)
    return out


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite_16b,
        jamba_v0_1_52b,
        kimi_k2_1t_a32b,
        llama_3_2_vision_11b,
        mamba2_780m,
        minicpm_2b,
        qwen1_5_0_5b,
        qwen2_72b,
        qwen2_7b,
        whisper_small,
    )
