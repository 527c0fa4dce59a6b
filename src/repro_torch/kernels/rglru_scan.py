"""RG-LRU scan with its gate algebra fused in: the CUDA kernel's wrapper and
its plain version.

Counterpart of ``repro/kernels/rglru_scan.py`` (the Pallas TPU kernel and
the gate algebra its wrapper computes around it). The kernel is
``csrc/rglru_scan.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.rglru_scan`, a log-depth scan. The TPU
kernel's tiling arguments (``cs``, ``bw``, ``interpret``) are gone: the
kernel picks its own split of S and W.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rglru_scan as plain

__all__ = ["rglru_scan", "plain", "launches"]

#: kernel launches made by :func:`rglru_scan` in this process
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    lib.rglru_scan_fwd.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    lib.rglru_scan_fwd.restype = _I
    return lib


def rglru_scan(x: torch.Tensor, a_gate: torch.Tensor, i_gate: torch.Tensor,
               lam: torch.Tensor, h0: "torch.Tensor | None" = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU on the card. x, a_gate, i_gate: (B,S,W) fp32 CUDA,
    contiguous; lam: (W,); h0: (B,W) or None for a zero state.
    Returns (y (B,S,W), h_last (B,W))."""
    global launches
    _build.refuse_grad("rglru_scan", x, a_gate, i_gate, lam, h0)
    b, s, w = x.shape
    checks = [("x", x, (b, s, w)), ("a_gate", a_gate, (b, s, w)),
              ("i_gate", i_gate, (b, s, w)), ("lam", lam, (w,))]
    if h0 is not None:
        checks.append(("h0", h0, (b, w)))
    for name, t, shape in checks:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _lib()
    y = torch.empty_like(x)
    h_last = x.new_empty(b, w)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_fwd(x.data_ptr(), a_gate.data_ptr(),
                                 i_gate.data_ptr(), lam.data_ptr(),
                                 None if h0 is None else h0.data_ptr(),
                                 y.data_ptr(), h_last.data_ptr(), b, s, w,
                                 stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y, h_last
