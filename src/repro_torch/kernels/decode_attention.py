"""Single-token decode attention over a KV cache: the CUDA kernel's wrapper
and its plain version.

Counterpart of ``repro/kernels/decode_attention.py`` (the Pallas TPU
kernel). The kernel is ``csrc/decode_attention.cu``, a split-S pass and a
combining pass; its plain PyTorch version is
:func:`repro_torch.kernels.ref.decode_attention`. The cache is read in
place in its (B,S,KV,D) layout, fp32 or bf16 (widened in registers); the
TPU wrapper transposed a full copy of it on every call.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import decode_attention as plain

__all__ = ["decode_attention", "plain", "launches"]

#: kernel launches (one split pass and its combine) made by
#: :func:`decode_attention` in this process
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.decode_attention_fwd.argtypes = ([_P] * 8 + [_L] * 6 + [_I] * 6
                                         + [ctypes.c_float, _P])
    lib.decode_attention_fwd.restype = _I
    for name in ("decode_attention_block", "decode_attention_max_group",
                 "decode_attention_max_d"):
        getattr(lib, name).restype = _I
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention on the card. q: (B,H,D) fp32 CUDA, contiguous;
    k, v: (B,S,KV,D) fp32 or bf16 (one type for both), any strides with the
    last dim contiguous; lengths: (B,) int32 on the same device.
    Returns (B,H,D) fp32."""
    global launches
    _build.refuse_grad("decode_attention", q, k, v)
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if not q.is_cuda or q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("q must be a contiguous float32 CUDA tensor")
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or \
                t.dtype != k.dtype:
            raise ValueError(f"{name} must be float32 or bfloat16 like k, "
                             f"got {t.dtype}")
        if tuple(t.shape) != (b, s, kv, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(b, s, kv, d)}")
        if (t.stride(3) != 1 or any(st % 4 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"aligned rows")
    if (not lengths.is_cuda or lengths.device != q.device
            or lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,)
            or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a ({b},) int32 CUDA tensor on "
                         f"{q.device}")
    lib = _lib()
    if h % kv or h // kv > lib.decode_attention_max_group():
        raise ValueError(f"{h} query heads over {kv} KV heads: the group "
                         f"must divide evenly and be at most "
                         f"{lib.decode_attention_max_group()}")
    if d % 4 or d > lib.decode_attention_max_d():
        raise ValueError(f"head dim {d} must be a multiple of 4 and at most "
                         f"{lib.decode_attention_max_d()}")
    ns = -(-s // lib.decode_attention_block())
    m_part = q.new_empty(b * h * ns)
    l_part = q.new_empty(b * h * ns)
    acc_part = q.new_empty(b * h * ns * d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            out.data_ptr(), *k.stride()[:3], *v.stride()[:3], b, h, kv, s, d,
            int(k.dtype == torch.bfloat16), d ** -0.5, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
