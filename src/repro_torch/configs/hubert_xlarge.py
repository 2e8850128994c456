"""hubert-xlarge [audio] — 48L d1280 16H (MHA kv=16) ff5120 vocab 504
(cluster targets), encoder-only [arXiv:2106.07447; unverified].

The conv waveform frontend is a stub: ``input_specs``
feeds precomputed frame embeddings (B, S, 1280). Encoder-only ⇒ no decode
shapes (decode_32k / long_500k skipped).

A copy of ``repro/configs/hubert_xlarge.py``, widths untouched.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    is_encoder=True,
    embeds_input=True,
    pattern=(("attn", "mlp"),),
)
