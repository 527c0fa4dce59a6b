"""Chunkwise mLSTM: the CUDA kernels' wrapper and their plain versions.

Counterpart of ``repro/kernels/mlstm_scan.py`` (the Pallas TPU kernel). The
kernels are in ``csrc/mlstm_scan.cu``: the forward, its training instance
(which also saves what the backward reads) and the backward; their plain
PyTorch versions are :func:`repro_torch.kernels.ref.mlstm_chunkwise`,
``mlstm_chunkwise_fwd_states_ref`` and ``mlstm_chunkwise_bwd_ref``. The
kernels take no chunk size: they walk the sequence in chunks of their own
(``CHUNK`` = 16 rows), and the function does not depend on the chunk size
beyond rounding. The TPU kernel has no backward (``jax.grad``
differentiates the JAX model's jnp chunkwise form); the backward kernel is
the port's, so that no plain version runs on the card's training path.

Each CTA owns a D x ``dv`` column tile of the matrix memory C (of its
adjoint dC in the backward) in shared memory and walks the whole sequence
(backwards in the backward); :func:`geometry` chooses ``dv`` from
``TILE_WIDTHS`` so that the grid of B*H*D/dv CTAs fills the card in one
wave where it can. The kernels read ``dv`` as given. The backward's tile
is narrower (its shared memory also holds the chunk's rows whole), and
its dq and dk come as D/dv partial planes summed after the launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Mapping
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .ref import mlstm_chunkwise as plain
from .ref import mlstm_chunkwise_bwd_ref as plain_backward
from .ref import mlstm_chunkwise_fwd_states_ref as plain_forward_states
from .ref import mlstm_gate_grads

__all__ = ["mlstm_scan", "plain", "plain_forward_states", "plain_backward",
           "with_backward", "launches", "backward_launches", "bind",
           "Geometry", "geometry", "launch_geometry", "smem_bytes",
           "backward_smem_bytes", "tile_widths", "CHUNK", "THREADS",
           "TILE_WIDTHS", "MAX_D", "SMEM_LIMIT", "SAVED_STATES"]

#: forward kernel launches (store-free and training instances) made by
#: :func:`mlstm_scan` in this process
launches = 0
#: backward kernel launches made by :func:`mlstm_scan`'s backward
backward_launches = 0

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
#: what the training forward saves for the backward, the layout of
#: ``plain_forward_states`` at ``cs=CHUNK``: each chunk's starting C
#: (B,H,S/16,D,D), n (B,H,S/16,D) and stabiliser m (B,H,S/16), then each
#: row's m_row and signed normaliser n_t (B,H,S)
SAVED_STATES = ("C", "n", "m", "m_row", "n_row")

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
    lib.mlstm_scan_fwd_train.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.mlstm_scan_fwd_train.restype = _I
    lib.mlstm_scan_bwd.argtypes = [_P] * 15 + [_I] * 5 + [_P]
    lib.mlstm_scan_bwd.restype = _I
    for name in ("mlstm_scan_max_active", "mlstm_scan_bwd_max_active",
                 "mlstm_scan_smem_bytes", "mlstm_scan_bwd_smem_bytes"):
        getattr(lib, name).argtypes = [_I] * 2
        getattr(lib, name).restype = _I
    for name in ("mlstm_scan_chunk", "mlstm_scan_threads",
                 "mlstm_scan_max_d"):
        getattr(lib, name).restype = _I
    shapes = [(d, dv) for d in range(64, MAX_D + 1, 64) for dv in TILE_WIDTHS]
    if ((lib.mlstm_scan_chunk(), lib.mlstm_scan_threads(),
         lib.mlstm_scan_max_d()) != (CHUNK, THREADS, MAX_D)
            or any(lib.mlstm_scan_smem_bytes(d, dv) != smem_bytes(d, dv)
                   or lib.mlstm_scan_bwd_smem_bytes(d, dv)
                   != backward_smem_bytes(d, dv) for d, dv in shapes)):
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


def backward_smem_bytes(d: int, dv: int) -> int:
    """Shared memory of one backward CTA, as ``bwd_smem_floats`` in the
    kernel: the dC tile (rows padded to dv + 1), dn, the tile's n_c, the
    chunk's rows of q, k, v and grad_h (padded to d + 4), 16 L x L planes
    of partial sums, W and P, and nine row vectors."""
    ell = CHUNK
    return 4 * (d * (dv + 1) + d + dv + 4 * ell * (d + 4) + 18 * ell * ell
                + 9 * ell)


def _check_head_dim(d: int) -> None:
    if d % 64 or not 64 <= d <= MAX_D:
        raise ValueError(f"head dim {d} must be a multiple of 64 and at "
                         f"most {MAX_D}")


def tile_widths(d: int, backward: bool = False) -> list[int]:
    """The column tiles that divide ``d`` and fit one CTA's shared
    memory (the backward's with ``backward``), narrowest first."""
    _check_head_dim(d)
    size = backward_smem_bytes if backward else smem_bytes
    return [dv for dv in TILE_WIDTHS
            if d % dv == 0 and size(d, dv) <= SMEM_LIMIT]


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
    backward: bool = False

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
        return (backward_smem_bytes if self.backward else smem_bytes)(
            self.d, self.dv)


def geometry(b: int, h: int, d: int, n_sms: int,
             ctas_per_sm: Mapping[int, int],
             backward: bool = False) -> Geometry:
    """The launch for (b, h, d) on a card of ``n_sms`` SMs, each holding
    ``ctas_per_sm[dv]`` CTAs of tile width ``dv``: the narrowest tile whose
    grid is resident in one wave; where none is, the widest tile that fits,
    in waves. The forward's tiles, or with ``backward`` the backward's."""
    if b < 1 or h < 1 or n_sms < 1:
        raise ValueError(f"mlstm_scan needs b, h, n_sms >= 1, got {b}, {h}, "
                         f"{n_sms}")
    fits = [dv for dv in tile_widths(d, backward)
            if ctas_per_sm.get(dv, 0) >= 1]
    if not fits:
        raise ValueError(f"no column tile of head dim {d} is resident on "
                         f"the card")
    dv = next((dv for dv in fits
               if b * h * (d // dv) <= n_sms * ctas_per_sm[dv]), fits[-1])
    return Geometry(b, h, d, dv, n_sms, ctas_per_sm[dv], backward)


def launch_geometry(b: int, h: int, d: int,
                    device: "torch.device | None" = None,
                    backward: bool = False) -> Geometry:
    """:func:`geometry` with the card's SM count and its resident CTAs per
    SM for each tile width, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    gives them (for the backward kernel with ``backward``). Cached per
    shape and device."""
    _check_head_dim(d)
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (b, h, d, index, backward)
    if key not in _geometries:
        lib = _lib()
        query = (lib.mlstm_scan_bwd_max_active if backward
                 else lib.mlstm_scan_max_active)
        with torch.cuda.device(index):
            per = {dv: query(d, dv) for dv in tile_widths(d, backward)}
        bad = {dv: n for dv, n in per.items() if n < 0}
        if bad:
            raise RuntimeError(f"mlstm_scan occupancy query failed: CUDA "
                               f"errors {bad}")
        n_sms = torch.cuda.get_device_properties(index).multi_processor_count
        _geometries[key] = geometry(b, h, d, n_sms, per, backward)
    return _geometries[key]


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_raw: torch.Tensor, f_raw: torch.Tensor) -> torch.Tensor:
    """Chunkwise mLSTM from zero state on the card. q,k,v: (B,H,S,D) fp32
    CUDA, contiguous, D a multiple of 64 up to ``MAX_D``; i_raw,f_raw:
    (B,H,S). S must be a multiple of ``CHUNK`` (16). Returns h: (B,H,S,D).
    Under grad, with any input requiring it, the training forward kernel
    runs and the backward is the backward kernel (:func:`with_backward`);
    otherwise the store-free forward kernel runs alone."""
    args = (q, k, v, i_raw, f_raw)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return with_backward(_launch_train, _launch_backward, *args)
    return _launch(*args)


class _Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, forward, backward, *inputs):
        h, states = forward(*inputs)
        ctx.backward = backward
        ctx.save_for_backward(*inputs, h, *states)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_h):
        q, k, v, i_raw, f_raw, h, *states = ctx.saved_tensors
        return (None, None, *ctx.backward(q, k, v, i_raw, f_raw, h,
                                          tuple(states),
                                          grad_h.contiguous()))


def with_backward(forward, backward, *inputs) -> torch.Tensor:
    """``forward(*inputs)[0]``, differentiable by ``backward``: ``forward``
    takes q, k, v, i_raw, f_raw and returns ``(h, states)``;
    ``backward(q, k, v, i_raw, f_raw, h, states, grad_h)`` returns the
    five inputs' gradients. :func:`mlstm_scan` passes the kernels; the
    plain versions (``plain_forward_states``, ``plain_backward``, with a
    chunk size bound) fit the same slots."""
    return _Scan.apply(forward, backward, *inputs)


def _check_one(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check(q, k, v, i_raw, f_raw) -> None:
    b, h, s, d = q.shape
    for name, t, shape in (("q", q, (b, h, s, d)), ("k", k, (b, h, s, d)),
                           ("v", v, (b, h, s, d)), ("i_raw", i_raw, (b, h, s)),
                           ("f_raw", f_raw, (b, h, s))):
        _check_one(name, t, shape, q.device)
    if s % CHUNK:
        raise ValueError(f"sequence {s} must be a multiple of {CHUNK}")


def _state_shapes(b: int, h: int, s: int, d: int) -> tuple:
    nc = s // CHUNK
    return ((b, h, nc, d, d), (b, h, nc, d), (b, h, nc), (b, h, s),
            (b, h, s))


def _launch(q, k, v, i_raw, f_raw) -> torch.Tensor:
    return _forward(q, k, v, i_raw, f_raw, save=False)[0]


def _launch_train(q, k, v, i_raw, f_raw):
    return _forward(q, k, v, i_raw, f_raw, save=True)


def _forward(q, k, v, i_raw, f_raw, *, save: bool):
    """One forward launch: the store-free instance, or with ``save`` the
    training instance. Returns (h, states or None)."""
    global launches
    _check(q, k, v, i_raw, f_raw)
    b, h, s, d = q.shape
    geo = launch_geometry(b, h, d, q.device)
    out = torch.empty_like(q)
    states = tuple(q.new_empty(shape) for shape in _state_shapes(b, h, s, d)) \
        if save else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(),
                f_raw.data_ptr(), out.data_ptr())
        if save:
            err = _lib().mlstm_scan_fwd_train(
                *ptrs, *(x.data_ptr() for x in states), b, h, s, d, geo.dv,
                stream)
        else:
            err = _lib().mlstm_scan_fwd(*ptrs, b, h, s, d, geo.dv, stream)
    if err:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out, states


def _launch_backward(q, k, v, i_raw, f_raw, h, states, grad_h):
    """The backward kernel, the sums of its dq and dk planes, then the
    gate grads from dq and dk (``ref.mlstm_gate_grads``). Returns the
    gradients of q, k, v, i_raw, f_raw."""
    dq_part, dk_part, dv = _backward_kernel(q, k, v, i_raw, f_raw, h, states,
                                            grad_h)
    dq, dk = dq_part.sum(0), dk_part.sum(0)
    return (dq, dk, dv, *mlstm_gate_grads(q, k, f_raw, dq, dk))


def _backward_kernel(q, k, v, i_raw, f_raw, h, states, grad_h):
    """One backward kernel launch: dq's and dk's partial planes
    (D/dv,B,H,S,D) each, and dv (B,H,S,D)."""
    global backward_launches
    _check(q, k, v, i_raw, f_raw)
    b, nh, s, d = q.shape
    if len(states) != len(SAVED_STATES):
        raise ValueError(f"states must be the {len(SAVED_STATES)} tensors "
                         f"{SAVED_STATES}")
    for name, t, shape in (("h", h, (b, nh, s, d)),
                           ("grad_h", grad_h, (b, nh, s, d)),
                           *zip(SAVED_STATES, states,
                                _state_shapes(b, nh, s, d))):
        _check_one(name, t, shape, q.device)
    geo = launch_geometry(b, nh, d, q.device, backward=True)
    dq_part = q.new_empty(d // geo.dv, b, nh, s, d)
    dk_part = q.new_empty(d // geo.dv, b, nh, s, d)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mlstm_scan_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(),
            f_raw.data_ptr(), h.data_ptr(), grad_h.data_ptr(),
            *(x.data_ptr() for x in states), dq_part.data_ptr(),
            dk_part.data_ptr(), dv.data_ptr(), b, nh, s, d, geo.dv, stream)
    if err:
        raise RuntimeError(f"mlstm_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    backward_launches += 1
    return dq_part, dk_part, dv
