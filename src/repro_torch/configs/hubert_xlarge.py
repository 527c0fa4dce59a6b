"""HuBERT-XLarge [arXiv:2106.07447; unverified] — audio encoder.

48L, d_model 1280, 16 heads (MHA), d_ff 5120, vocab 504 (cluster units),
encoder-only (bidirectional attention, no causal mask, NO decode step).
The CNN waveform feature extractor is a STUB: the batch carries 512-dim
frame embeddings; positions use the conv positional encoding.
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, rope_kind="none", mlp_kind="gelu", norm="layernorm",
    frontend="audio", frontend_dim=512,
    decode_capable=False, subquadratic=False,
    source="arXiv:2106.07447; unverified",
)

SMOKE = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=32,
    causal=False, rope_kind="none", mlp_kind="gelu", norm="layernorm",
    frontend="audio", frontend_dim=16,
    decode_capable=False,
)

register(FULL, SMOKE)
