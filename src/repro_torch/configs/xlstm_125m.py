"""xLSTM-125M [arXiv:2405.04517; unverified].

12 blocks, d_model 768, 4 heads, vocab 50304, d_ff=0 (the xLSTM blocks
carry their own projections: mLSTM pre-up-projection x2, sLSTM post-MLP
x4/3). Ratio ~7:1 mLSTM:sLSTM — sLSTM at block indices {5, 11}
(documented approximation for 12 blocks). Recurrent => runs long_500k.
Small model: layers are unrolled (no scan) — HLO stays small anyway.
"""

from .base import ArchConfig, register
from ..models.xlstm import XLSTMDims

_PATTERN = tuple("slstm" if i in (5, 11) else "mlstm" for i in range(12))

FULL = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    pattern=_PATTERN, scan_layers=False,
    xlstm=XLSTMDims(d_model=768, n_heads=4),
    norm="layernorm", tie_embeddings=True,
    decode_capable=True, subquadratic=True,
    source="arXiv:2405.04517; unverified",
)

SMOKE = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab_size=128,
    pattern=("mlstm", "slstm", "mlstm"), scan_layers=False,
    xlstm=XLSTMDims(d_model=64, n_heads=2),
    norm="layernorm", tie_embeddings=True,
    decode_capable=True, subquadratic=True,
)

register(FULL, SMOKE)
