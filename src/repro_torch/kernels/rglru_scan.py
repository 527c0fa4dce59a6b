"""RG-LRU scan with its gate algebra fused in: the CUDA kernel's wrapper and
its plain version.

Counterpart of ``repro/kernels/rglru_scan.py`` (the Pallas TPU kernel and
the gate algebra its wrapper computes around it). The kernel is
``csrc/rglru_scan.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.rglru_scan`, a log-depth scan. The TPU
kernel's tiling arguments (``cs``, ``bw``, ``interpret``) are gone: the
kernel picks its own.

Each CTA owns a stripe of ``STRIPE`` channels of one batch row and walks
the whole sequence in tiles of up to ``TILE`` steps, copied into a ring of
``STAGES`` shared-memory stages, so each input byte crosses HBM once; one
scan warp runs the recurrence of a tile while worker warps copy, gate and
store the tiles around it. :func:`geometry` is that launch in plain
Python, and the kernel lays out its launch by the same rule (:func:`bind`
holds the two together).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import _build
from .autograd import recompute
from .ref import rglru_scan as plain

__all__ = ["rglru_scan", "plain", "launches", "bind", "Geometry",
           "geometry", "launch_geometry", "last_launch", "STRIPE", "TILE",
           "STAGES", "MAX_THREADS", "SMEM_LIMIT"]

#: kernel launches made by :func:`rglru_scan` in this process
launches = 0

#: channels a CTA, one lane each, as ``rglru_scan_stripe``
STRIPE = 32
#: steps a tile at most, as ``rglru_scan_tile``
TILE = 64
#: shared-memory stages of the ring, as ``rglru_scan_stages``
STAGES = 5
#: threads a CTA at most (the scan warp and a worker warp for every 4
#: steps of a tile, up to 16), as ``rglru_scan_max_threads``
MAX_THREADS = 544
#: shared memory one CTA may take on the card
SMEM_LIMIT = 232448
#: shared memory of one SM, and what the card reserves of it a CTA
SM_SMEM, CTA_RESERVED = 233472, 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_PLAN = ctypes.c_int * 7
_geometries: dict[tuple, "Geometry"] = {}
# shapes on which bind() holds the kernel's launch rule to geometry()'s
_PLAN_CHECKS = [(1, 4096, 4096), (4, 1, 4096), (2, 300, 200), (1, 65, 203),
                (3, 4097, 96), (1, 9, 5), (2, 63, 33)]


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("rglru_scan"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``rglru_scan.cu`` and check
    that it agrees with this module: the constants, and the launch it
    plans for a few shapes on either copy path."""
    lib.rglru_scan_fwd.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    lib.rglru_scan_fwd.restype = _I
    lib.rglru_scan_plan.argtypes = [_I] * 4 + [_P]
    lib.rglru_scan_plan.restype = None
    lib.rglru_scan_last_launch.argtypes = [_P]
    lib.rglru_scan_last_launch.restype = None
    lib.rglru_scan_max_active.argtypes = [_I] * 4
    lib.rglru_scan_max_active.restype = _I
    for name in ("rglru_scan_stripe", "rglru_scan_tile", "rglru_scan_stages",
                 "rglru_scan_max_threads"):
        getattr(lib, name).restype = _I
    if (lib.rglru_scan_stripe(), lib.rglru_scan_tile(),
            lib.rglru_scan_stages(), lib.rglru_scan_max_threads()) != \
            (STRIPE, TILE, STAGES, MAX_THREADS):
        raise RuntimeError("rglru_scan.cu and its wrapper disagree on the "
                           "stripe, the tile, the stages or the threads")
    for shape in _PLAN_CHECKS:
        for vec in (True, False):
            out = _PLAN()
            lib.rglru_scan_plan(*shape, int(vec), out)
            if tuple(out) != geometry(*shape, vec=vec).plan:
                raise RuntimeError(f"rglru_scan.cu plans {tuple(out)} for "
                                   f"{shape}, vec={vec}; its wrapper "
                                   f"{geometry(*shape, vec=vec).plan}")
    return lib


@dataclass(frozen=True)
class Geometry:
    """One launch: a grid of (ceil(w / STRIPE), b) CTAs of ``threads``
    threads, CTA (x, batch) walking channels [x*STRIPE, (x+1)*STRIPE) of
    row ``batch`` over S in ``n_tiles`` tiles of ``tile`` steps, through a
    ring of ``stages`` shared-memory stages and two y tiles; one scan warp
    and ``threads`` - 32 workers; 16-byte copies when ``vec``, 4-byte ones
    otherwise."""
    b: int
    s: int
    w: int
    vec: bool          # rows 16-byte aligned: the 16-byte copy path
    with_h0: bool      # an initial state is read
    n_sms: int
    ctas_per_sm: int   # resident CTAs per SM

    stripe = STRIPE

    @property
    def tile(self) -> int:
        return min(TILE, self.s)

    @property
    def n_tiles(self) -> int:
        return math.ceil(self.s / self.tile)

    @property
    def stages(self) -> int:
        """Stages allocated: the ring's, or as many as there are tiles."""
        return min(STAGES, self.n_tiles)

    @property
    def threads(self) -> int:
        return 32 + min(MAX_THREADS - 32, 32 * math.ceil(self.tile / 4))

    @property
    def ctas_x(self) -> int:
        return math.ceil(self.w / STRIPE)

    @property
    def ctas(self) -> int:
        return self.ctas_x * self.b

    @property
    def waves(self) -> int:
        return math.ceil(self.ctas / (self.n_sms * self.ctas_per_sm))

    @property
    def stage_bytes(self) -> int:
        """One tile of x, a_gate and i_gate."""
        return 4 * 3 * self.tile * STRIPE

    @property
    def smem_bytes(self) -> int:
        """The ring's stages and two y tiles."""
        return self.stages * self.stage_bytes + 2 * 4 * self.tile * STRIPE

    @property
    def in_flight_per_sm(self) -> int:
        """Bytes a busy SM keeps in flight: STAGES - 2 tiles a CTA (the
        ring less the tile scanned and the tile gated; all of a short
        launch's tiles), times the CTAs resident on it."""
        resident = min(self.ctas_per_sm, math.ceil(self.ctas / self.n_sms))
        return min(STAGES - 2, self.n_tiles) * self.stage_bytes * resident

    @property
    def hbm_bytes(self) -> int:
        """Bytes the launch moves, each once: x, a_gate and i_gate read, y
        written, lambda read, h_last written, h0 read if given."""
        b, s, w = self.b, self.s, self.w
        return (12 * b * s * w + 4 * b * s * w + 4 * w + 4 * b * w
                + (4 * b * w if self.with_h0 else 0))

    @property
    def plan(self) -> tuple[int, ...]:
        """As ``rglru_scan_plan`` lays it out: CTAs along W, CTAs along B,
        threads, shared bytes, tile, stages, vec."""
        return (self.ctas_x, self.b, self.threads, self.smem_bytes,
                self.tile, self.stages, int(self.vec))

    def tiles(self) -> list[tuple[int, int, int, int, int]]:
        """Every (batch, t0, t1, w0, w1) block a CTA's tile covers, steps
        [t0, t1) of channels [w0, w1), cut at S and W as the kernel cuts
        them."""
        return [(bb, k * self.tile, min(self.s, (k + 1) * self.tile),
                 x * STRIPE, min(self.w, (x + 1) * STRIPE))
                for bb in range(self.b) for x in range(self.ctas_x)
                for k in range(self.n_tiles)]


def _check_shape(b: int, s: int, w: int) -> None:
    if min(b, s, w) < 1 or b > 65535:
        raise ValueError(f"rglru_scan needs 1 <= B <= 65535 and S, W >= 1, "
                         f"got {b}, {s}, {w}")


def geometry(b: int, s: int, w: int, *, vec: "bool | None" = None,
             with_h0: bool = False, n_sms: int = 132,
             ctas_per_sm: "int | None" = None) -> Geometry:
    """The launch for (b, s, w) on a card of ``n_sms`` SMs. ``vec`` is the
    copy path (by default the 16-byte one where W is a multiple of 4, as
    for aligned base addresses); ``ctas_per_sm`` defaults to what shared
    memory and threads allow (the card's own count, which registers also
    bound, comes from :func:`launch_geometry`)."""
    _check_shape(b, s, w)
    vec = w % 4 == 0 if vec is None else bool(vec)
    geo = Geometry(b, s, w, vec, bool(with_h0), n_sms, 1)
    if ctas_per_sm is None:
        ctas_per_sm = min(32, 2048 // geo.threads,
                          SM_SMEM // (geo.smem_bytes + CTA_RESERVED))
    return Geometry(b, s, w, vec, bool(with_h0), n_sms, ctas_per_sm)


def launch_geometry(b: int, s: int, w: int, *, aligned: bool = True,
                    with_h0: bool = False,
                    device: "torch.device | None" = None) -> Geometry:
    """:func:`geometry` with the card's SM count and its resident CTAs per
    SM, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them;
    the 16-byte path where W is a multiple of 4 and the base addresses are
    ``aligned``, as the kernel decides it."""
    _check_shape(b, s, w)
    vec = w % 4 == 0 and aligned
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (b, s, w, vec, index)
    if key not in _geometries:
        with torch.cuda.device(index):
            per_sm = _lib().rglru_scan_max_active(b, s, w, int(vec))
        if per_sm < 1:
            raise RuntimeError(f"rglru_scan occupancy query failed: CUDA "
                               f"error {-per_sm}")
        n_sms = torch.cuda.get_device_properties(index).multi_processor_count
        _geometries[key] = geometry(b, s, w, vec=vec, n_sms=n_sms,
                                    ctas_per_sm=per_sm)
    return geometry(b, s, w, vec=vec, with_h0=with_h0,
                    n_sms=_geometries[key].n_sms,
                    ctas_per_sm=_geometries[key].ctas_per_sm)


def last_launch() -> tuple[int, ...]:
    """The plan of the kernel's last launch in this process, laid out as
    :attr:`Geometry.plan`."""
    out = _PLAN()
    _lib().rglru_scan_last_launch(out)
    return tuple(out)


def rglru_scan(x: torch.Tensor, a_gate: torch.Tensor, i_gate: torch.Tensor,
               lam: torch.Tensor, h0: "torch.Tensor | None" = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU on the card. x, a_gate, i_gate: (B,S,W) fp32 CUDA,
    contiguous, any B <= 65535, S, W >= 1; lam: (W,); h0: (B,W) or None
    for a zero state. Returns (y (B,S,W), h_last (B,W)). Differentiable in
    both outputs: the backward recomputes through :func:`plain` and
    differentiates that (``autograd.py``)."""
    return recompute(_launch, plain, x, a_gate, i_gate, lam, h0)


def _launch(x, a_gate, i_gate, lam, h0) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
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
    _check_shape(b, s, w)
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
