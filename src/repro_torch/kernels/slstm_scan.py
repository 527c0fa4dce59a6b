"""Sequential sLSTM: the CUDA kernels' wrapper and their plain versions.

Counterpart of ``repro/kernels/slstm_scan.py`` (the Pallas TPU kernel). The
kernels are in ``csrc/slstm_scan.cu``: the forward, its training instance
(which also saves what the backward reads) and the backward; their plain
PyTorch versions are :func:`repro_torch.kernels.ref.slstm_scan_ref`,
``slstm_scan_fwd_states_ref`` and ``slstm_scan_bwd_ref``. The TPU kernel's
tiling arguments (``cs``, ``interpret``) are gone: one launch covers the
whole sequence. The TPU kernel has no backward (``jax.grad`` differentiates
the JAX model's ``lax.scan``); the backward kernel is the port's, so that
no plain version runs on the card's training path.

The kernel runs one thread block cluster of ``cl`` CTAs per head and ``rb``
batch rows; CTA ``r`` of a cluster owns units ``[r*hd/cl, (r+1)*hd/cl)`` of
all four gates and holds that slice of R on chip for the whole sequence.
:func:`geometry` chooses ``cl`` and ``rb``; the kernel reads them as given.
The backward runs on the same clusters, CTA ``r`` holding rows
``[r*hd/cl, (r+1)*hd/cl)`` of the four R; ``dR`` is one batched product
after it (``ref.slstm_recurrent_grads``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .ref import slstm_recurrent_grads
from .ref import slstm_scan_bwd_ref as plain_backward
from .ref import slstm_scan_fwd_states_ref as plain_forward_states
from .ref import slstm_scan_ref as plain

__all__ = ["slstm_scan", "plain", "plain_forward_states", "plain_backward",
           "with_backward", "launches", "backward_launches", "Geometry",
           "cluster_size", "geometry", "launch_geometry",
           "backward_resident_clusters", "MAX_HD", "MAX_ROWS", "R_HELD_IN",
           "SAVED_PLANES"]

#: forward kernel launches (store-free and training instances) made by
#: :func:`slstm_scan` in this process
launches = 0
#: backward kernel launches made by :func:`slstm_scan`'s backward
backward_launches = 0

#: largest head dim (a multiple of 16 up to this), as ``slstm_scan_max_hd``
MAX_HD = 256
#: most batch rows one cluster serves, as ``slstm_scan_max_rows``
MAX_ROWS = 4
#: where each CTA keeps its slice of R for the whole launch
R_HELD_IN = "registers"
#: what the training forward saves for the backward, a (B,NH,S,HD) plane
#: each: the pre-activations with their recurrent part, then c, n, m
SAVED_PLANES = ("z", "i", "f", "o", "c", "n", "m")

_P = ctypes.c_void_p
_I = ctypes.c_int
_geometries: dict[tuple, "Geometry"] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("slstm_scan")
    lib.slstm_scan_fwd.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.slstm_scan_fwd.restype = _I
    lib.slstm_scan_fwd_train.argtypes = [_P] * 10 + [_I] * 6 + [_P]
    lib.slstm_scan_fwd_train.restype = _I
    lib.slstm_scan_bwd.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.slstm_scan_bwd.restype = _I
    lib.slstm_scan_max_active_clusters.argtypes = [_I] * 4
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
                                                      min(b, MAX_ROWS), 0)
        if n < 0:
            raise RuntimeError(f"slstm_scan occupancy query failed: CUDA "
                               f"error {-n}")
        _geometries[key] = geometry(b, nh, hd, n)
    return _geometries[key]


def backward_resident_clusters(geo: Geometry,
                               device: "torch.device | None" = None) -> int:
    """How many clusters of the backward kernel at ``geo`` the card holds
    at once (``cudaOccupancyMaxActiveClusters``); the backward runs on the
    forward's geometry, in waves where fewer are resident."""
    device = torch.device("cuda") if device is None else torch.device(device)
    with torch.cuda.device(device):
        n = _lib().slstm_scan_max_active_clusters(geo.hd, geo.cl, geo.rb, 1)
    if n < 0:
        raise RuntimeError(f"slstm_scan backward occupancy query failed: "
                           f"CUDA error {-n}")
    return n


def slstm_scan(z, i, f, o, rz, ri, rf, ro) -> torch.Tensor:
    """sLSTM from zero state on the card. z,i,f,o: (B,NH,S,HD) fp32 CUDA
    pre-activations, contiguous; r*: (NH,HD,HD) indexed [in, out]; HD a
    multiple of 16 up to 256. Returns h: (B,NH,S,HD). Under grad, with any
    input requiring it, the training forward kernel runs and the backward
    is the backward kernel (:func:`with_backward`); otherwise the
    store-free forward kernel runs alone."""
    args = (z, i, f, o, rz, ri, rf, ro)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return with_backward(_launch_train, _launch_backward, *args)
    return _launch(*args)


class _Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, forward, backward, *inputs):
        h, states = forward(*inputs)
        ctx.backward = backward
        ctx.save_for_backward(h, states, *inputs[4:])
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_h):
        h, states, *rs = ctx.saved_tensors
        return (None, None,
                *ctx.backward(h, states, *rs, grad_h.contiguous()))


def with_backward(forward, backward, *inputs) -> torch.Tensor:
    """``forward(*inputs)[0]``, differentiable by ``backward``: ``forward``
    takes z, i, f, o, r_z, r_i, r_f, r_o and returns ``(h, states)``;
    ``backward(h, states, r_z, r_i, r_f, r_o, grad_h)`` returns the eight
    inputs' gradients. :func:`slstm_scan` passes the kernels; the plain
    versions (``plain_forward_states``, ``plain_backward``) fit the same
    slots."""
    return _Scan.apply(forward, backward, *inputs)


def _check(z, i, f, o, rz, ri, rf, ro) -> None:
    b, nh, s, hd = z.shape
    seq, rec = (b, nh, s, hd), (nh, hd, hd)
    for name, t, shape in (("z", z, seq), ("i", i, seq), ("f", f, seq),
                           ("o", o, seq), ("rz", rz, rec), ("ri", ri, rec),
                           ("rf", rf, rec), ("ro", ro, rec)):
        _check_one(name, t, shape, z.device)


def _check_one(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(z, i, f, o, rz, ri, rf, ro) -> torch.Tensor:
    return _forward(z, i, f, o, rz, ri, rf, ro, save=False)[0]


def _launch_train(z, i, f, o, rz, ri, rf, ro):
    return _forward(z, i, f, o, rz, ri, rf, ro, save=True)


def _forward(z, i, f, o, rz, ri, rf, ro, *, save: bool):
    """One forward launch: the store-free instance, or with ``save`` the
    training instance. Returns (h, states or None)."""
    global launches
    _check(z, i, f, o, rz, ri, rf, ro)
    b, nh, s, hd = z.shape
    geo = launch_geometry(b, nh, hd, z.device)
    out = torch.empty_like(z)
    states = z.new_empty(len(SAVED_PLANES), b, nh, s, hd) if save else None
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (z.data_ptr(), i.data_ptr(), f.data_ptr(), o.data_ptr(),
                rz.data_ptr(), ri.data_ptr(), rf.data_ptr(), ro.data_ptr(),
                out.data_ptr())
        if save:
            err = _lib().slstm_scan_fwd_train(*ptrs, states.data_ptr(), b,
                                              nh, s, hd, geo.cl, geo.rb,
                                              stream)
        else:
            err = _lib().slstm_scan_fwd(*ptrs, b, nh, s, hd, geo.cl, geo.rb,
                                        stream)
    if err:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out, states


def _launch_backward(h, states, rz, ri, rf, ro, grad_h):
    """The backward kernel, then dR by one batched product. Returns the
    gradients of z, i, f, o, r_z, r_i, r_f, r_o."""
    dpre = _backward_kernel(h, states, rz, ri, rf, ro, grad_h)
    return (*dpre.unbind(0), *slstm_recurrent_grads(h, dpre))


def _backward_kernel(h, states, rz, ri, rf, ro, grad_h) -> torch.Tensor:
    """One backward kernel launch: dpre (4,B,NH,S,HD), the gradients of
    the pre-activations z, i, f, o."""
    global backward_launches
    b, nh, s, hd = h.shape
    seq, rec = (b, nh, s, hd), (nh, hd, hd)
    for name, t, shape in (("h", h, seq),
                           ("states", states, (len(SAVED_PLANES), *seq)),
                           ("grad_h", grad_h, seq), ("rz", rz, rec),
                           ("ri", ri, rec), ("rf", rf, rec), ("ro", ro, rec)):
        _check_one(name, t, shape, h.device)
    geo = launch_geometry(b, nh, hd, h.device)
    dpre = h.new_empty(4, b, nh, s, hd)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().slstm_scan_bwd(
            states.data_ptr(), grad_h.data_ptr(), rz.data_ptr(),
            ri.data_ptr(), rf.data_ptr(), ro.data_ptr(), dpre.data_ptr(), b,
            nh, s, hd, geo.cl, geo.rb, stream)
    if err:
        raise RuntimeError(f"slstm_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    backward_launches += 1
    return dpre
