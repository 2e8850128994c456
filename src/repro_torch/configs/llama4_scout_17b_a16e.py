"""llama4-scout-17b-a16e [moe] — 48L d5120 40H (GQA kv=8) ff8192
vocab 202048, MoE 16 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Early fusion is stubbed to the text backbone per the assignment (the
modality frontend supplies embeddings upstream of this stack). Top-1
routing stresses overflow the hardest — a key stealing-policy cell.

A copy of ``repro/configs/llama4_scout_17b_a16e.py``, widths untouched.
The port runs it at reduced size (the shared expert's parity); at full
width it waits for distribution.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500000.0,
    pattern=(("attn", "moe"),),
    moe_num_experts=16,
    moe_top_k=1,
    moe_d_ff=8192,
    moe_shared_expert=True,
)
