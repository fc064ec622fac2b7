"""Model configuration schema for all assigned architectures (the port's
copy of ``repro.configs.base``)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    """Mamba2-style SSD block parameters (zamba2)."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class RWKVCfg:
    """RWKV-6 'Finch' time-mix parameters."""
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class EncoderCfg:
    """Encoder tower for enc-dec (whisper) / VLM (pixtral) backbones.
    The modality frontend (conv / ViT patchifier) is a STUB: input_specs()
    provides precomputed frame/patch embeddings of width d_model."""
    n_layers: int
    n_frames: int          # encoder sequence length (audio frames / patches)
    is_causal: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // n_heads
    mlp: str = "swiglu"                   # swiglu | geglu | gelu
    qkv_bias: bool = False
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    pos: str = "rope"                     # rope | learned | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rwkv: Optional[RWKVCfg] = None
    encoder: Optional[EncoderCfg] = None
    attn_every: int = 0                   # zamba2: shared attn block period
    sliding_window: int = 0               # 0 = full attention
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # training-shape metadata
    max_seq: int = 32_768

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the long_500k shape? (DESIGN.md §4)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 2,
            d_ff=128,
            vocab_size=256,
            head_dim=16 if self.head_dim else None,
            max_seq=128,
        )
        if self.moe:
            kw["moe"] = MoECfg(n_experts=4, top_k=2, d_ff_expert=64)
        if self.ssm:
            kw["ssm"] = SSMCfg(state_dim=8, head_dim=16, expand=2, chunk=16)
        if self.rwkv:
            kw["rwkv"] = RWKVCfg(head_dim=16, decay_lora=8, chunk=16)
        if self.encoder:
            kw["encoder"] = EncoderCfg(n_layers=2, n_frames=16,
                                       is_causal=self.encoder.is_causal)
        if self.attn_every:
            kw["attn_every"] = 2
        if self.sliding_window:
            kw["sliding_window"] = 64
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}
