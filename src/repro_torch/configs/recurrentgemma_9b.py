"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified].

38 blocks, d_model 4096, d_ff 12288, vocab 256000. The MLP is the
config's default ``mlp_kind`` (SwiGLU), as in the JAX package's config.
Temporal mixing pattern 1:2 — (RG-LRU, RG-LRU, local-attention) repeated;
38 = 12 x (R,R,A) + (R,R), so the stages are ((R,R,A), 12), ((R,), 2).
Local attention is MQA (kv=1), window 2048, 16 heads x head_dim 256.
lru_width 4096. Sub-quadratic => runs long_500k.
"""

from .base import ArchConfig, register
from ..models.rglru import RGLRUDims

_PATTERN = (("rglru", "rglru", "lattn") * 12) + ("rglru", "rglru")

FULL = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    pattern=_PATTERN,
    attn_window=2048, rope_theta=1e4,
    rglru=RGLRUDims(d_model=4096, lru_width=4096),
    logits_softcap=30.0,
    decode_capable=True, subquadratic=True,
    source="arXiv:2402.19427; unverified",
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab_size=128, head_dim=16,
    pattern=("rglru", "rglru", "lattn", "rglru", "rglru"),
    attn_window=16,
    rglru=RGLRUDims(d_model=64, lru_width=64),
    logits_softcap=30.0,
    decode_capable=True, subquadratic=True,
)

register(FULL, SMOKE)
