"""granite-moe-1b-a400m [moe] — 24L d1024 16H (GQA kv=8) expert-ff 512
vocab 49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

The most representative cell for the paper technique: 32 experts top-8
stresses capacity overflow; locality-aware stealing is on by default.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    rope_theta=10000.0,
    tie_embeddings=True,
    pattern=(("attn", "moe"),),
    moe_num_experts=32,
    moe_top_k=8,
    moe_d_ff=512,
)
