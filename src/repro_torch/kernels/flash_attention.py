"""Flash attention forward (GQA, causal and window masks): the CUDA
kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention.py`` (the Pallas TPU
kernel). The kernel is ``csrc/flash_attention.cu``; its plain PyTorch
version is :func:`repro_torch.kernels.ref.flash_attention`. The kernel
reads q, k and v through their strides, so the model hands it (B,H,S,D)
views of its (B,S,H,D) projections without a copy, and the output keeps
q's layout. The TPU kernel's block arguments (``bq``, ``bk``,
``interpret``) are gone: the kernel uses its own tiles.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention as plain

__all__ = ["flash_attention", "plain", "launches", "HEAD_DIMS"]

#: kernel launches made by :func:`flash_attention` in this process
launches = 0

#: head dims the kernel is built for
HEAD_DIMS = (64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = ([_P] * 4 + [_L] * 12 + [_I] * 8
                                        + [ctypes.c_float, _P])
    lib.flash_attention_fwd.restype = _I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: "int | None" = None) -> torch.Tensor:
    """Attention on the card. q: (B,H,Sq,D); k, v: (B,KV,Skv,D), fp32
    CUDA, any strides with the last dim contiguous and 16-byte aligned
    rows; H a multiple of KV; D in ``HEAD_DIMS``. Returns (B,H,Sq,D) in
    q's layout."""
    global launches
    _build.refuse_grad("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, kv, skv, d)),
                           ("v", v, (b, kv, skv, d))):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype} (the "
                             f"kernel takes fp32 inputs only)")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if (t.stride(3) != 1 or any(st % 4 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"16-byte aligned rows")
    if h % kv:
        raise ValueError(f"{h} query heads do not split over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    out = torch.empty_like(q)          # keeps q's strides
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, h, kv, sq, skv, d, int(causal),
            0 if window is None else window, d ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
