"""Qwen2-VL-72B — VLM backbone [arXiv:2409.12191; hf].

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064, M-RoPE
(multimodal 3-axis rotary, sections 16/24/24 over head_dim/2 = 64).
Vision frontend (ViT + merger) is a STUB: input_specs() provides
pre-computed patch embeddings merged into the token stream.
"""

from .base import ArchConfig, register

FULL = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    rope_kind="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision",
    decode_capable=True, subquadratic=False,
    source="arXiv:2409.12191; hf",
)

SMOKE = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128, head_dim=16,
    rope_kind="mrope", mrope_sections=(2, 3, 3),
    frontend="vision",
)

register(FULL, SMOKE)
