"""Nemotron-4-340B [arXiv:2402.16819 (Nemotron-4 15B report describes the
family); unverified] — dense GQA with squared-ReLU MLP.

96L, d_model 18432, 96 heads (GQA kv=8), d_ff 73728, vocab 256000.
Note: squared-ReLU means no gate matrix — d_ff 73728 is the single up
projection width.
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    mlp_kind="squared_relu",
    rope_theta=1e4,
    source="arXiv:2402.16819; unverified",
)

SMOKE = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab_size=128,
    mlp_kind="squared_relu",
)

register(FULL, SMOKE)
