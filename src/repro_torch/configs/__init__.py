"""Architecture registry of the port: ``get(name)`` / ``ARCHS``.

Only the architectures whose layers the port runs are registered; the
others join with the slices that port their layers.
"""

from . import (granite_moe_1b_a400m, llama4_scout_17b_a16e, mamba2_1_3b,
               qwen2_5_3b, qwen3_14b, stablelm_1_6b)
from .base import ArchConfig

_MODULES = [granite_moe_1b_a400m, llama4_scout_17b_a16e, stablelm_1_6b,
            qwen2_5_3b, qwen3_14b, mamba2_1_3b]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get", "ArchConfig"]
