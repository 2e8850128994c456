"""qwen3-14b [dense] — 40L d5120 40H (GQA kv=8) ff17408 vocab 151936,
qk-norm [hf:Qwen/Qwen3-14B per assignment; hf].

A copy of ``repro/configs/qwen3_14b.py``, widths untouched.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    rope_theta=1000000.0,
    qk_norm=True,
    pattern=(("attn", "mlp"),),
)
