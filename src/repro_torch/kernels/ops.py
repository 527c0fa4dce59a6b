"""Dispatch for the ported kernels: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor.

Counterpart of ``repro/kernels/ops.py``. Nothing falls back: a CUDA tensor
that the kernel cannot take raises. ``kernel_impl="plain"`` runs the plain
version on any device; it exists so that the same model can be held
against its own kernel-free run on the card.

The kernels take a narrower set of shapes than the TPU kernels, which take
any; on a CUDA tensor anything else raises:

- ``mlstm_scan``: fp32; D a multiple of 64 up to 512, S a multiple of 16.
- ``slstm_scan``: fp32; a head dim that is a multiple of 16 up to 256.
- ``rglru_scan``: fp32; any S and W, B up to 65535.
- ``flash_attention``: q, k and v all fp32 or all bf16; D in
  ``HEAD_DIMS`` = (64, 80, 128, 256), 80 being HuBERT's 1280 / 16; causal
  or not, any window, H a multiple of KV.
- ``decode_attention``: q fp32 or bf16 and caches fp32 or bf16; D a
  multiple of 4 up to 256, H / KV up to 16.

Each wrapper is differentiable: its forward is the kernel and its backward
recomputes the plain version from the saved inputs and differentiates that
(``autograd.py``), so a gradient through a kernel is the plain path's.
"""

from __future__ import annotations

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import mlstm_scan as _mlstm
from . import rglru_scan as _rglru
from . import slstm_scan as _slstm

KERNEL_IMPLS = ("hopper", "plain")


def _use_kernel(x, kernel_impl: str) -> bool:
    if kernel_impl not in KERNEL_IMPLS:
        raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}, "
                         f"got {kernel_impl!r}")
    return kernel_impl == "hopper" and x.is_cuda


def mlstm_scan(q, k, v, i_raw, f_raw, *, cs: int = 256,
               kernel_impl: str = "hopper"):
    """Chunkwise mLSTM from zero state. ``cs`` is the plain version's chunk;
    the kernel uses its own (16 rows, so S must be a multiple of 16)."""
    if _use_kernel(q, kernel_impl):
        return _mlstm.mlstm_scan(q, k, v, i_raw, f_raw)
    return _mlstm.plain(q, k, v, i_raw, f_raw, cs=cs)


def slstm_scan(z, i, f, o, rz, ri, rf, ro, *, kernel_impl: str = "hopper"):
    """Sequential sLSTM from zero state on (B,NH,S,HD) pre-activations."""
    if _use_kernel(z, kernel_impl):
        return _slstm.slstm_scan(z, i, f, o, rz, ri, rf, ro)
    return _slstm.plain(z, i, f, o, rz, ri, rf, ro)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    kernel_impl: str = "hopper"):
    """Attention over a whole sequence. q: (B,H,S,D); k, v: (B,KV,S,D),
    views in any layout."""
    if _use_kernel(q, kernel_impl):
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return _flash.plain(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths, *, kernel_impl: str = "hopper"):
    """One token against a cache. q: (B,H,D); k, v: (B,S,KV,D); lengths:
    (B,) int32."""
    if _use_kernel(q, kernel_impl):
        return _decode.decode_attention(q, k, v, lengths)
    return _decode.plain(q, k, v, lengths)


def rglru_scan(x, a_gate, i_gate, lam, h0=None, *,
               kernel_impl: str = "hopper"):
    """RG-LRU with its gates on (B,S,W) fp32 from h0 (zeros when None).
    Returns (y, h_last)."""
    if _use_kernel(x, kernel_impl):
        return _rglru.rglru_scan(x, a_gate, i_gate, lam, h0)
    return _rglru.plain(x, a_gate, i_gate, lam, h0)
