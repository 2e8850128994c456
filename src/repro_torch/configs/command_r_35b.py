"""command-r-35b [dense] — 40L d8192 64H (GQA kv=8) ff22528
vocab 256000, no bias [hf:CohereForAI/c4ai-command-r-v01; unverified].

A copy of ``repro/configs/command_r_35b.py``, widths untouched.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8000000.0,
    tie_embeddings=True,
    pattern=(("attn", "mlp"),),
)
