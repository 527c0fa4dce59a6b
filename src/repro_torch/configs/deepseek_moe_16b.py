"""DeepSeekMoE-16B [arXiv:2401.06066; hf].

28L, d_model 2048, 16 heads (MHA kv=16), vocab 102400.
Fine-grained MoE: 64 routed experts top-6 with expert d_ff 1408 plus
2 shared experts; the FIRST layer is a dense FFN (width 10944) per the
released config.
"""

from .base import ArchConfig, register
from ..models.moe import MoEDims

FULL = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    moe=MoEDims(d_model=2048, n_experts=64, top_k=6, d_expert=1408,
                n_shared=2),
    moe_first_dense=1, moe_dense_ff=10944,
    rope_theta=1e4,
    source="arXiv:2401.06066; hf",
)

SMOKE = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab_size=128,
    moe=MoEDims(d_model=64, n_experts=8, top_k=3, d_expert=32, n_shared=1,
                capacity_factor=4.0),
    moe_first_dense=1, moe_dense_ff=128,
)

register(FULL, SMOKE)
