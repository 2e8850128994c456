"""Architecture registry of the port: ``get(name)`` / ``ARCHS``.

The same ten architectures as the JAX package's registry.
"""

from . import (command_r_35b, granite_moe_1b_a400m, hubert_xlarge,
               jamba_1_5_large_398b, llama4_scout_17b_a16e,
               llama_3_2_vision_90b, mamba2_1_3b, qwen2_5_3b, qwen3_14b,
               stablelm_1_6b)
from .base import SHAPES, ArchConfig, ShapeSpec

_MODULES = [
    llama_3_2_vision_90b, granite_moe_1b_a400m, llama4_scout_17b_a16e,
    stablelm_1_6b, qwen2_5_3b, command_r_35b, qwen3_14b,
    jamba_1_5_large_398b, hubert_xlarge, mamba2_1_3b,
]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get", "ArchConfig", "ShapeSpec", "SHAPES"]
