"""Sequential sLSTM forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/slstm_scan.py`` (the Pallas TPU kernel). The
kernel is ``csrc/slstm_scan.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.slstm_scan_ref`. The TPU kernel's tiling
arguments (``cs``, ``interpret``) are gone: one launch covers the whole
sequence.

The kernel runs one thread block cluster of ``cl`` CTAs per head and ``rb``
batch rows; CTA ``r`` of a cluster owns units ``[r*hd/cl, (r+1)*hd/cl)`` of
all four gates and holds that slice of R on chip for the whole sequence.
:func:`geometry` chooses ``cl`` and ``rb``; the kernel reads them as given.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from . import _build
from .autograd import recompute
from .ref import slstm_scan_ref as plain

__all__ = ["slstm_scan", "plain", "launches", "Geometry", "cluster_size",
           "geometry", "launch_geometry", "MAX_HD", "MAX_ROWS", "R_HELD_IN"]

#: kernel launches made by :func:`slstm_scan` in this process
launches = 0

#: largest head dim (a multiple of 16 up to this), as ``slstm_scan_max_hd``
MAX_HD = 256
#: most batch rows one cluster serves, as ``slstm_scan_max_rows``
MAX_ROWS = 4
#: where each CTA keeps its slice of R for the whole launch
R_HELD_IN = "registers"

_P = ctypes.c_void_p
_I = ctypes.c_int
_geometries: dict[tuple, "Geometry"] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("slstm_scan")
    lib.slstm_scan_fwd.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.slstm_scan_fwd.restype = _I
    lib.slstm_scan_max_active_clusters.argtypes = [_I] * 3
    lib.slstm_scan_max_active_clusters.restype = _I
    lib.slstm_scan_max_hd.restype = _I
    lib.slstm_scan_max_rows.restype = _I
    if (lib.slstm_scan_max_hd(), lib.slstm_scan_max_rows()) != (MAX_HD,
                                                                MAX_ROWS):
        raise RuntimeError("slstm_scan.cu and its wrapper disagree on "
                           "MAX_HD or MAX_ROWS")
    return lib


def cluster_size(hd: int) -> int:
    """CTAs per cluster for head dim ``hd``, as ``cluster_ctas`` in the
    kernel: each CTA holds a slice of R, 4 x hd x hd/cl fp32 (72 KiB at
    hd=192, cl=8), in its threads' registers."""
    if hd % 16 or not 16 <= hd <= MAX_HD:
        raise ValueError(f"slstm_scan takes a head dim that is a multiple "
                         f"of 16 up to {MAX_HD}, got {hd}")
    return 4 if hd <= 128 else 8


@dataclass(frozen=True)
class Geometry:
    """One launch's layout. Cluster ``c`` serves head ``c % nh`` and batch
    rows ``[(c // nh) * rb, ... + rb)``, as the kernel computes them."""
    b: int
    nh: int
    hd: int
    cl: int                    # CTAs per cluster
    rb: int                    # batch rows per cluster
    max_active_clusters: int   # clusters the card holds at once

    @property
    def units(self) -> int:
        """Units of each gate that one CTA owns."""
        return self.hd // self.cl

    @property
    def threads(self) -> int:
        """Threads per CTA: 16 a unit, each holding the unit's four gates
        over a sixteenth of K."""
        return 16 * self.units

    @property
    def n_clusters(self) -> int:
        return self.nh * math.ceil(self.b / self.rb)

    @property
    def grid(self) -> int:
        """CTAs in the launch."""
        return self.cl * self.n_clusters

    def chains(self, cluster: int) -> list[tuple[int, int]]:
        """The (batch, head) pairs that cluster ``cluster`` serves."""
        head, b0 = cluster % self.nh, (cluster // self.nh) * self.rb
        return [(b, head) for b in range(b0, min(b0 + self.rb, self.b))]

    def units_of(self, rank: int) -> range:
        """The units that CTA ``rank`` of a cluster owns."""
        return range(rank * self.units, (rank + 1) * self.units)


def geometry(b: int, nh: int, hd: int, max_active_clusters: int) -> Geometry:
    """The launch for (b, nh, hd) on a card that holds
    ``max_active_clusters`` clusters at once: ``rb`` is the smallest row
    count (up to MAX_ROWS) for which all clusters are resident together;
    where none is, ``MAX_ROWS`` rows and the clusters run in waves."""
    cl = cluster_size(hd)
    if b < 1 or nh < 1:
        raise ValueError(f"slstm_scan needs b, nh >= 1, got {b}, {nh}")
    top = min(b, MAX_ROWS)
    rb = next((r for r in range(1, top + 1)
               if nh * math.ceil(b / r) <= max_active_clusters), top)
    return Geometry(b, nh, hd, cl, rb, max_active_clusters)


def launch_geometry(b: int, nh: int, hd: int,
                    device: "torch.device | None" = None) -> Geometry:
    """:func:`geometry` with the card's count of resident clusters, as
    ``cudaOccupancyMaxActiveClusters`` gives it (at the most shared memory
    any row count up to ``b`` takes). Cached per shape and device."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (b, nh, hd, index)
    if key not in _geometries:
        cl = cluster_size(hd)
        with torch.cuda.device(index):
            n = _lib().slstm_scan_max_active_clusters(hd, cl,
                                                      min(b, MAX_ROWS))
        if n < 0:
            raise RuntimeError(f"slstm_scan occupancy query failed: CUDA "
                               f"error {-n}")
        _geometries[key] = geometry(b, nh, hd, n)
    return _geometries[key]


def slstm_scan(z, i, f, o, rz, ri, rf, ro) -> torch.Tensor:
    """sLSTM from zero state on the card. z,i,f,o: (B,NH,S,HD) fp32 CUDA
    pre-activations, contiguous; r*: (NH,HD,HD) indexed [in, out]; HD a
    multiple of 16 up to 256. Returns h: (B,NH,S,HD). Differentiable: the
    backward recomputes through :func:`plain` and differentiates that
    (``autograd.py``)."""
    return recompute(_launch, plain, z, i, f, o, rz, ri, rf, ro)


def _launch(z, i, f, o, rz, ri, rf, ro) -> torch.Tensor:
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
    geo = launch_geometry(b, nh, hd, z.device)
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().slstm_scan_fwd(
            z.data_ptr(), i.data_ptr(), f.data_ptr(), o.data_ptr(),
            rz.data_ptr(), ri.data_ptr(), rf.data_ptr(), ro.data_ptr(),
            out.data_ptr(), b, nh, s, hd, geo.cl, geo.rb, stream)
    if err:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
