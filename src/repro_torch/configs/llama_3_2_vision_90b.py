"""llama-3.2-vision-90b [vlm] — 100L d8192 64H (GQA kv=8) ff28672
vocab 128256; gated cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment; unverified].

The vision frontend is a stub: ``input_specs`` feeds
precomputed patch embeddings as cross-attention media.

A copy of ``repro/configs/llama_3_2_vision_90b.py``, widths untouched.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    # period 5: four self-attention layers, then one gated cross-attn
    pattern=(("attn", "mlp"),) * 4 + (("cross", "mlp"),),
    num_media_tokens=1024,   # stubbed patch embeddings per example
)
