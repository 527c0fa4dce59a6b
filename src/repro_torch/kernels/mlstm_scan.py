"""Chunkwise mLSTM forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/mlstm_scan.py`` (the Pallas TPU kernel). The
kernel is ``csrc/mlstm_scan.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.mlstm_chunkwise`. The kernel takes no chunk
size: it walks the sequence in chunks of its own (32 rows), and the function
does not depend on the chunk size beyond rounding.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import mlstm_chunkwise as plain

__all__ = ["mlstm_scan", "plain", "launches"]

#: kernel launches made by :func:`mlstm_scan` in this process
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_scan")
    lib.mlstm_scan_fwd.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    lib.mlstm_scan_fwd.restype = _I
    lib.mlstm_scan_max_d.restype = _I
    lib.mlstm_scan_chunk.restype = _I
    return lib


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_raw: torch.Tensor, f_raw: torch.Tensor) -> torch.Tensor:
    """Chunkwise mLSTM from zero state on the card. q,k,v: (B,H,S,D) fp32
    CUDA, contiguous, D a multiple of 64; i_raw,f_raw: (B,H,S). S must be a
    multiple of the kernel's chunk (32). Returns h: (B,H,S,D)."""
    global launches
    b, h, s, d = q.shape
    for name, t, shape in (("q", q, (b, h, s, d)), ("k", k, (b, h, s, d)),
                           ("v", v, (b, h, s, d)), ("i_raw", i_raw, (b, h, s)),
                           ("f_raw", f_raw, (b, h, s))):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _lib()
    if d % 64 or d > lib.mlstm_scan_max_d():
        raise ValueError(f"head dim {d} must be a multiple of 64 and at "
                         f"most {lib.mlstm_scan_max_d()}")
    if s % lib.mlstm_scan_chunk():
        raise ValueError(f"sequence {s} must be a multiple of "
                         f"{lib.mlstm_scan_chunk()}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_scan_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 i_raw.data_ptr(), f_raw.data_ptr(),
                                 out.data_ptr(), b, h, s, d, stream)
    if err:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
