"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) ff24576
vocab 65536, MoE 16e top-2, Mamba:attention 7:1 interleave
[arXiv:2403.19887; hf].

Period of 8 layers: one attention + seven Mamba2 mixers; MoE replaces the
MLP on every other layer (odd slots). Runs long_500k (sub-quadratic).

A copy of ``repro/configs/jamba_1_5_large_398b.py``, widths untouched.
"""

from .base import ArchConfig

_PERIOD = []
for i in range(8):
    kind = "attn" if i == 0 else "mamba"
    ffn = "moe" if i % 2 == 1 else "mlp"
    _PERIOD.append((kind, ffn))

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=1000000.0,
    pattern=tuple(_PERIOD),
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
)
