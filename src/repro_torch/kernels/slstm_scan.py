"""Sequential sLSTM forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/slstm_scan.py`` (the Pallas TPU kernel). The
kernel is ``csrc/slstm_scan.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.slstm_scan_ref`. The TPU kernel's tiling
arguments (``cs``, ``interpret``) are gone: one launch covers the whole
sequence.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import slstm_scan_ref as plain

__all__ = ["slstm_scan", "plain", "launches"]

#: kernel launches made by :func:`slstm_scan` in this process
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("slstm_scan")
    lib.slstm_scan_fwd.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    lib.slstm_scan_fwd.restype = _I
    lib.slstm_scan_max_hd.restype = _I
    return lib


def slstm_scan(z, i, f, o, rz, ri, rf, ro) -> torch.Tensor:
    """sLSTM from zero state on the card. z,i,f,o: (B,NH,S,HD) fp32 CUDA
    pre-activations, contiguous; r*: (NH,HD,HD) indexed [in, out].
    Returns h: (B,NH,S,HD)."""
    global launches
    b, nh, s, hd = z.shape
    seq, rec = (b, nh, s, hd), (nh, hd, hd)
    for name, t, shape in (("z", z, seq), ("i", i, seq), ("f", f, seq),
                           ("o", o, seq), ("rz", rz, rec), ("ri", ri, rec),
                           ("rf", rf, rec), ("ro", ro, rec)):
        if not t.is_cuda or t.device != z.device:
            raise ValueError(f"{name} must be a CUDA tensor on {z.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _lib()
    if hd > lib.slstm_scan_max_hd():
        raise ValueError(f"head dim {hd} exceeds {lib.slstm_scan_max_hd()}")
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.slstm_scan_fwd(z.data_ptr(), i.data_ptr(), f.data_ptr(),
                                 o.data_ptr(), rz.data_ptr(), ri.data_ptr(),
                                 rf.data_ptr(), ro.data_ptr(), out.data_ptr(),
                                 b, nh, s, hd, stream)
    if err:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
