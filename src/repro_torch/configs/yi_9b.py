"""Yi-9B [arXiv:2403.04652; hf] — llama-arch GQA.

48L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    rope_theta=1e4,
    source="arXiv:2403.04652; hf",
)

SMOKE = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128,
)

register(FULL, SMOKE)
