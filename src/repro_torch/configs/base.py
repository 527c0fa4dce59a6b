"""ArchConfig / ShapeSpec: the assigned architectures and input shapes.

Every architecture file in this package registers exactly one full-size
config (the published numbers) plus a ``smoke`` reduced config of the same
family for CPU tests. The port registers xLSTM-125M, RecurrentGemma-9B,
the GQA family (Yi-9B, Yi-34B, Nemotron-4-340B, Qwen2-VL-72B), the MoE
family (Qwen1.5-MoE-A2.7B, DeepSeekMoE-16B), MLA (MiniCPM3-4B) and the
audio encoder (HuBERT-XLarge).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.mla import MLADims
from ..models.moe import MoEDims
from ..models.rglru import RGLRUDims
from ..models.xlstm import XLSTMDims


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # block structure
    block: str = "attn"               # uniform stack kind
    pattern: Optional[tuple] = None   # explicit per-layer kinds (overrides)
    scan_layers: bool = True
    # attention details
    causal: bool = True
    qk_norm: bool = False
    attn_window: Optional[int] = None
    rope_kind: str = "rope"           # rope | mrope | none
    rope_theta: float = 1e6
    mrope_sections: tuple = (16, 24, 24)
    # mlp
    mlp_kind: str = "swiglu"
    # families
    moe: Optional[MoEDims] = None
    moe_first_dense: int = 0
    moe_dense_ff: int = 0
    mla: Optional[MLADims] = None
    rglru: Optional[RGLRUDims] = None
    xlstm: Optional[XLSTMDims] = None
    # frontend stubs
    frontend: Optional[str] = None    # vision | audio
    frontend_dim: int = 512
    # misc
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    # capability flags (drive cell applicability)
    decode_capable: bool = True
    subquadratic: bool = False
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    # -- layer pattern & scan stages -----------------------------------------

    @property
    def layer_pattern(self) -> tuple:
        if self.pattern is not None:
            return self.pattern
        if self.moe is not None:
            dense = ("dense",) * self.moe_first_dense
            return dense + ("moe",) * (self.n_layers - self.moe_first_dense)
        return (self.block,) * self.n_layers

    @property
    def stages(self) -> tuple:
        """((pattern_unit, repeat), ...) — repeat>1 stages run under scan."""
        pat = self.layer_pattern
        if not self.scan_layers:
            return ((pat, 1),)
        # find the longest uniform-unit prefix decomposition: greedy split
        # into (prefix of distinct layers, repeated unit, suffix)
        stages: list = []
        i = 0
        n = len(pat)
        while i < n:
            # try unit sizes 1..3 and take the one with most repeats
            best = (pat[i:i + 1], 1)
            for unit in (1, 2, 3):
                u = pat[i:i + unit]
                if len(u) < unit:
                    continue
                r = 1
                while pat[i + r * unit: i + (r + 1) * unit] == u:
                    r += 1
                if r * unit > len(best[0]) * best[1]:
                    best = (u, r)
            stages.append(best)
            i += len(best[0]) * best[1]
        # merge singleton stages into unrolled groups
        merged: list = []
        for u, r in stages:
            if r == 1 and merged and merged[-1][1] == 1:
                merged[-1] = (merged[-1][0] + u, 1)
            else:
                merged.append((u, r))
        return tuple((tuple(u), r) for u, r in merged)

    def supports(self, shape: "ShapeSpec") -> tuple[bool, str]:
        """(runnable, reason-if-skipped) for a cell (DESIGN.md §6)."""
        if shape.kind in ("decode", "long_decode") and not self.decode_capable:
            return False, "encoder-only architecture has no decode step"
        if shape.kind == "long_decode" and not self.subquadratic:
            return False, ("full quadratic attention; 500k context "
                           "infeasible (DESIGN.md §6)")
        return True, ""


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}


ARCH_REGISTRY: dict[str, ArchConfig] = {}
SMOKE_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_arch(name: str, *, smoke: bool = False) -> ArchConfig:
    _ensure_loaded()
    reg = SMOKE_REGISTRY if smoke else ARCH_REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")
    return reg[name]


def all_archs() -> list[str]:
    _ensure_loaded()
    return sorted(ARCH_REGISTRY)


_loaded = False


def _ensure_loaded():
    global _loaded
    if _loaded:
        return
    from . import (deepseek_moe_16b, hubert_xlarge,  # noqa: F401
                   minicpm3_4b, nemotron_4_340b, qwen2_moe_a2_7b, qwen2_vl_72b,
                   recurrentgemma_9b, xlstm_125m, yi_9b, yi_34b)
    _loaded = True
