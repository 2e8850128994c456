"""Architecture config schema (port of ``repro/configs/base.py``).

Each architecture file instantiates :class:`ArchConfig` with the exact
published numbers; ``reduced()`` derives the same-family small config
for CPU tests. ``SHAPES`` is the JAX package's shape grid (the data
pipeline sizes its batches from a :class:`ShapeSpec`); its dry-run and
sharding fields have no counterpart here yet.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

LayerKind = Literal["attn", "mamba", "cross"]
FfnKind = Literal["mlp", "moe", "none"]
Slot = tuple[LayerKind, FfnKind]       # (mixer kind, ffn kind)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The LM shape grid (same for every arch; applicability filters below).
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads
    pattern: tuple[Slot, ...] = (("attn", "mlp"),)

    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    attn_window: int | None = None
    attn_impl: str = "ref"           # 'ref' | 'kernel'
    kv_repeat: int = 1
    # long-sequence attention: above the threshold, loop over q chunks so
    # the score slab stays (chunk × Skv) instead of (Sq × Skv)
    attn_chunk: int = 1024
    attn_chunk_threshold: int = 8192

    # modality
    is_encoder: bool = False
    embeds_input: bool = False
    num_media_tokens: int = 0

    # embeddings / head
    tie_embeddings: bool = False

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 4096
    moe_impl: str = "einsum"         # 'einsum' | 'kernel'
    moe_shared_expert: bool = False
    moe_steal_attempts: int = 2      # paper technique; 0 = vanilla drops
    moe_steal_policy: str = "dfwspt"

    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_impl: str = "ref"

    # numerics / training
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: str = "full"              # none|full|dots
    router_aux_weight: float = 0.01
    z_loss_weight: float = 1e-4

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not a multiple "
                f"of pattern period {len(self.pattern)}")

    # ------------------------------------------------------------------
    @property
    def repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def sub_quadratic(self) -> bool:
        """True if sequence cost is sub-quadratic (SSM/hybrid)."""
        return "mamba" in {k for k, _ in self.pattern}

    def shapes(self) -> list[str]:
        """Applicable shape cells for this arch."""
        out = ["train_4k", "prefill_32k"]
        if not self.is_encoder:
            out.append("decode_32k")
            if self.sub_quadratic:
                out.append("long_500k")
        return out

    def skipped_shapes(self) -> dict[str, str]:
        sk = {}
        if self.is_encoder:
            sk["decode_32k"] = "encoder-only: no decode step"
            sk["long_500k"] = "encoder-only: no decode step"
        elif not self.sub_quadratic:
            sk["long_500k"] = ("pure full-attention arch: 500k decode "
                               "needs sub-quadratic attention")
        return sk

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU tests (the JAX package's own)."""
        period = len(self.pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=period * 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            moe_d_ff=32 if self.moe_num_experts else 0,
            moe_num_experts=min(self.moe_num_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            moe_group=256,
            num_media_tokens=8 if self.num_media_tokens else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_groups=1,
            ssm_chunk=16,
            dtype="float32",
            remat="none",
        )
