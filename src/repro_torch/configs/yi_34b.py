"""Yi-34B [arXiv:2403.04652; hf] — llama-arch GQA.

60L, d_model 7168, 56 heads (GQA kv=8), d_ff 20480, vocab 64000.
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    rope_theta=1e4,
    source="arXiv:2403.04652; hf",
)

SMOKE = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab_size=128,
)

register(FULL, SMOKE)
