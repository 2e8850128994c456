"""stablelm-1.6b [dense] — 24L d2048 32H (MHA: kv=32) ff5632
vocab 100352 [hf:stabilityai/stablelm-2-1_6b; unverified].

Note: the HF model uses LayerNorm + partial rotary; we keep the package's
RMSNorm/full-rotary (dims, heads and widths are exact — noted in
the JAX package as a family-level simplification).

A copy of ``repro/configs/stablelm_1_6b.py``, widths untouched.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10000.0,
    pattern=(("attn", "mlp"),),
)
