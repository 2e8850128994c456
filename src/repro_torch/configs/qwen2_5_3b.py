"""qwen2.5-3b [dense] — 36L d2048 16H (GQA kv=2) ff11008 vocab 151936,
QKV bias, tied embeddings [hf:Qwen/Qwen2.5-3B; hf].

A copy of ``repro/configs/qwen2_5_3b.py``, widths untouched.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    rope_theta=1000000.0,
    qkv_bias=True,
    tie_embeddings=True,
    pattern=(("attn", "mlp"),),
)
