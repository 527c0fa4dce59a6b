"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; hf] — MLA (multi-head latent attn).

62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448.
MLA dims per the released config: q_lora_rank 768, kv_lora_rank 256,
qk_nope 64, qk_rope 32, v_head 64. The decode cache stores only the
(c_kv, k_rope) latents — (256+32) per token instead of 2*40*96.
"""

from .base import ArchConfig, register
from ..models.mla import MLADims

FULL = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    block="mla",
    mla=MLADims(d_model=2560, n_heads=40, q_lora_rank=768, kv_lora_rank=256,
                qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    rope_theta=1e4,
    source="hf:openbmb/MiniCPM3-4B",
)

SMOKE = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=128,
    block="mla",
    mla=MLADims(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8),
)

register(FULL, SMOKE)
