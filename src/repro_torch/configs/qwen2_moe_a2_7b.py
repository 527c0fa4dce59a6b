"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L, d_model 2048, 16 heads (MHA kv=16), vocab 151936.
MoE: 60 routed experts top-4 with expert d_ff 1408, plus a shared expert of
width 5632 = 4x1408 ("4 shared") always active.
"""

from .base import ArchConfig, register
from ..models.moe import MoEDims

FULL = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    moe=MoEDims(d_model=2048, n_experts=60, top_k=4, d_expert=1408,
                n_shared=4, n_experts_padded=64),
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab_size=128,
    moe=MoEDims(d_model=64, n_experts=8, top_k=2, d_expert=32, n_shared=2,
                capacity_factor=4.0),
)

register(FULL, SMOKE)
