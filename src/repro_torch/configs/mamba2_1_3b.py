"""mamba2-1.3b [ssm] — 48L d2048, attention-free SSD blocks (no MLP),
vocab 50280, ssm_state=128 [arXiv:2405.21060; hf:state-spaces/mamba2-1.3b].

A copy of ``repro/configs/mamba2_1_3b.py``. Attention-free: the paper's
*stealing* component is inapplicable (no expert queues, no attention
shards); the port runs it because its training forward is the one path
that reaches the ``ssd_scan`` kernel.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,          # unused (attention-free); head_dim set explicitly
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    pattern=(("mamba", "none"),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
)
