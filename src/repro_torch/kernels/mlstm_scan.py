"""Chunkwise mLSTM forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/mlstm_scan.py`` (the Pallas TPU kernel). The
kernel is ``csrc/mlstm_scan.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.mlstm_chunkwise`. The kernel takes no chunk
size: it walks the sequence in chunks of its own (``CHUNK`` = 16 rows), and
the function does not depend on the chunk size beyond rounding.

Each CTA owns a D x ``dv`` column tile of the matrix memory C in shared
memory and walks the whole sequence; :func:`geometry` chooses ``dv`` from
``TILE_WIDTHS`` so that the grid of B*H*D/dv CTAs fills the card in one
wave where it can. The kernel reads ``dv`` as given.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Mapping
from dataclasses import dataclass

import torch

from . import _build
from .autograd import recompute
from .ref import mlstm_chunkwise as plain

__all__ = ["mlstm_scan", "plain", "launches", "bind", "Geometry", "geometry",
           "launch_geometry", "smem_bytes", "tile_widths", "CHUNK",
           "THREADS", "TILE_WIDTHS", "MAX_D", "SMEM_LIMIT"]

#: kernel launches made by :func:`mlstm_scan` in this process
launches = 0

#: rows per chunk, as ``mlstm_scan_chunk``; S must be a multiple of it
CHUNK = 16
#: threads per CTA, as ``mlstm_scan_threads``
THREADS = 512
#: column tile widths the kernel is built for
TILE_WIDTHS = (32, 64, 96)
#: largest head dim (the kernel is built for each multiple of 64 up to
#: this), as ``mlstm_scan_max_d``
MAX_D = 512
#: shared memory one CTA may take on the card
SMEM_LIMIT = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_geometries: dict[tuple, "Geometry"] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("mlstm_scan"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``mlstm_scan.cu`` (the plain
    one, or one with extra defines) and check that it agrees with this
    module's constants."""
    lib.mlstm_scan_fwd.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    lib.mlstm_scan_fwd.restype = _I
    lib.mlstm_scan_max_active.argtypes = [_I] * 2
    lib.mlstm_scan_max_active.restype = _I
    lib.mlstm_scan_smem_bytes.argtypes = [_I] * 2
    lib.mlstm_scan_smem_bytes.restype = _I
    for name in ("mlstm_scan_chunk", "mlstm_scan_threads",
                 "mlstm_scan_max_d"):
        getattr(lib, name).restype = _I
    if ((lib.mlstm_scan_chunk(), lib.mlstm_scan_threads(),
         lib.mlstm_scan_max_d()) != (CHUNK, THREADS, MAX_D)
            or any(lib.mlstm_scan_smem_bytes(d, dv) != smem_bytes(d, dv)
                   for d in range(64, MAX_D + 1, 64) for dv in TILE_WIDTHS)):
        raise RuntimeError("mlstm_scan.cu and its wrapper disagree on the "
                           "chunk, the threads, MAX_D or shared memory")
    return lib


def smem_bytes(d: int, dv: int) -> int:
    """Shared memory of one CTA, as ``smem_floats`` in the kernel: the C
    tile with the chunk's v rows, q and W, two regions that take turns
    holding k and the partial sums (4 tiles of the readout, 16 slices of
    the scores), n and seven gate vectors."""
    ell = CHUNK
    region = max(ell * (d + 4), 4 * ell * dv, 16 * ell * ell)
    return 4 * ((d + ell) * dv + ell * (d + ell + 4) + 2 * region + d
                + 7 * ell)


def _check_head_dim(d: int) -> None:
    if d % 64 or not 64 <= d <= MAX_D:
        raise ValueError(f"head dim {d} must be a multiple of 64 and at "
                         f"most {MAX_D}")


def tile_widths(d: int) -> list[int]:
    """The column tiles that divide ``d`` and fit one CTA's shared
    memory, narrowest first."""
    _check_head_dim(d)
    return [dv for dv in TILE_WIDTHS
            if d % dv == 0 and smem_bytes(d, dv) <= SMEM_LIMIT]


@dataclass(frozen=True)
class Geometry:
    """One launch's layout: a grid of (d/dv, h, b) CTAs of ``THREADS``
    threads, CTA (x, head, batch) owning columns [x*dv, (x+1)*dv) of C."""
    b: int
    h: int
    d: int
    dv: int            # columns of C a CTA owns
    n_sms: int
    ctas_per_sm: int   # resident CTAs per SM at this dv

    threads = THREADS

    @property
    def grid(self) -> int:
        """CTAs in the launch."""
        return self.b * self.h * (self.d // self.dv)

    @property
    def waves(self) -> int:
        return math.ceil(self.grid / (self.n_sms * self.ctas_per_sm))

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.d, self.dv)


def geometry(b: int, h: int, d: int, n_sms: int,
             ctas_per_sm: Mapping[int, int]) -> Geometry:
    """The launch for (b, h, d) on a card of ``n_sms`` SMs, each holding
    ``ctas_per_sm[dv]`` CTAs of tile width ``dv``: the narrowest tile whose
    grid is resident in one wave; where none is, the widest tile that fits,
    in waves."""
    if b < 1 or h < 1 or n_sms < 1:
        raise ValueError(f"mlstm_scan needs b, h, n_sms >= 1, got {b}, {h}, "
                         f"{n_sms}")
    fits = [dv for dv in tile_widths(d) if ctas_per_sm.get(dv, 0) >= 1]
    if not fits:
        raise ValueError(f"no column tile of head dim {d} is resident on "
                         f"the card")
    dv = next((dv for dv in fits
               if b * h * (d // dv) <= n_sms * ctas_per_sm[dv]), fits[-1])
    return Geometry(b, h, d, dv, n_sms, ctas_per_sm[dv])


def launch_geometry(b: int, h: int, d: int,
                    device: "torch.device | None" = None) -> Geometry:
    """:func:`geometry` with the card's SM count and its resident CTAs per
    SM for each tile width, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    gives them. Cached per shape and device."""
    _check_head_dim(d)
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (b, h, d, index)
    if key not in _geometries:
        lib = _lib()
        with torch.cuda.device(index):
            per = {dv: lib.mlstm_scan_max_active(d, dv)
                   for dv in tile_widths(d)}
        bad = {dv: n for dv, n in per.items() if n < 0}
        if bad:
            raise RuntimeError(f"mlstm_scan occupancy query failed: CUDA "
                               f"errors {bad}")
        n_sms = torch.cuda.get_device_properties(index).multi_processor_count
        _geometries[key] = geometry(b, h, d, n_sms, per)
    return _geometries[key]


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_raw: torch.Tensor, f_raw: torch.Tensor) -> torch.Tensor:
    """Chunkwise mLSTM from zero state on the card. q,k,v: (B,H,S,D) fp32
    CUDA, contiguous, D a multiple of 64 up to ``MAX_D``; i_raw,f_raw:
    (B,H,S). S must be a multiple of ``CHUNK`` (16). Returns h: (B,H,S,D).
    Differentiable: the backward recomputes through :func:`plain`
    (``cs=256``) and differentiates that (``autograd.py``)."""
    return recompute(_launch, plain, q, k, v, i_raw, f_raw)


def _launch(q, k, v, i_raw, f_raw) -> torch.Tensor:
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
    if s % CHUNK:
        raise ValueError(f"sequence {s} must be a multiple of {CHUNK}")
    geo = launch_geometry(b, h, d, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mlstm_scan_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    i_raw.data_ptr(), f_raw.data_ptr(),
                                    out.data_ptr(), b, h, s, d, geo.dv,
                                    stream)
    if err:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
