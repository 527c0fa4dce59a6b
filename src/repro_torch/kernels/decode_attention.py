"""Single-token decode attention over a KV cache: the CUDA kernel's wrapper
and its plain version.

Counterpart of ``repro/kernels/decode_attention.py`` (the Pallas TPU
kernel). The kernel is ``csrc/decode_attention.cu``, a split pass over
chunks of ``CH`` cache positions and a combining pass; its plain PyTorch
version is :func:`repro_torch.kernels.ref.decode_attention`. The cache is
read in place in its (B,S,KV,D) layout, fp32 or bf16 (widened in
registers); the TPU wrapper transposed a full copy of it on every call.
q is fp32 or bf16, whatever the cache's type, and the output takes q's
type: a bf16 q is widened on its load and the fp32 result rounded at the
store, so it gives bit for bit the fp32 q's result, rounded.

The grid is fixed on the host by the shapes alone: (ceil(S / CH), KV, B)
split CTAs, of which those whose chunk starts at or past the row's length
exit at once. The lengths are read on the device only, so a call never
waits for the card and replays in a CUDA graph with new lengths.
:func:`launch_geometry` is that launch in plain Python (:func:`bind` holds
the kernel's own plan to it).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from . import _build
from .autograd import recompute
from .ref import decode_attention as plain

__all__ = ["decode_attention", "plain", "launches", "bind", "declare",
           "call", "Geometry",
           "launch_geometry", "last_launch", "max_active", "CH", "THREADS",
           "MAX_GROUP", "MAX_D", "SMEM_LIMIT", "COMBINE_COLS"]

#: kernel launches (one split pass and its combine) made by
#: :func:`decode_attention` in this process
launches = 0

#: cache positions a split CTA, as ``decode_attention_block``
CH = 32
#: threads a split CTA (and a combine CTA), as ``decode_attention_threads``
THREADS = 256
#: query heads per KV head and head dim at most, as
#: ``decode_attention_max_group`` and ``decode_attention_max_d``
MAX_GROUP, MAX_D = 16, 256
#: shared memory one CTA may take on the card
SMEM_LIMIT = 232448
#: shared memory of one SM, and what the card reserves of it a CTA
SM_SMEM, CTA_RESERVED = 233472, 1024
#: bytes after each shared K, V and q row (bank spread)
PAD = 16
#: head-dim columns a combine CTA
COMBINE_COLS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PLAN = ctypes.c_int * 7
# shapes (b, h, kv, s, d, bf16, vec16) on which bind() holds the kernel's
# plan to launch_geometry()'s
_PLAN_CHECKS = [(4, 16, 1, 2048, 256, 0, 1), (4, 16, 1, 2048, 256, 1, 1),
                (2, 4, 2, 300, 128, 1, 1), (3, 8, 8, 100, 64, 0, 1),
                (1, 16, 1, 1, 68, 1, 0), (2, 32, 2, 2049, 64, 1, 0),
                (1, 3, 1, 33, 4, 0, 1), (4, 32, 4, 4096, 128, 0, 1),
                (2, 56, 8, 300, 128, 1, 1), (2, 56, 8, 300, 128, 0, 1)]


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("decode_attention"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point ``decode_attention_fwd`` of a build of
    ``decode_attention.cu``, which every version of the source shares (an
    older one included), and check that its chunk is at least ``CH``
    positions, so that :func:`call`'s partials hold its blocks."""
    _declare_fwd(lib.decode_attention_fwd)
    lib.decode_attention_block.restype = _I
    if lib.decode_attention_block() < CH:
        raise RuntimeError(f"a build of decode_attention.cu with chunks of "
                           f"{lib.decode_attention_block()} positions needs "
                           f"more partials than {CH}-position chunks")
    return lib


def _declare_fwd(fwd) -> None:
    fwd.argtypes = [_P] * 8 + [_L] * 6 + [_I] * 6 + [ctypes.c_float, _P]
    fwd.restype = _I


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of this tree's build of
    ``decode_attention.cu`` (:func:`declare`, and
    ``decode_attention_fwd_bf16_q``: the same arguments, q and out bf16)
    and check that it agrees with this module: the constants, and the
    launch it plans for a few shapes on either copy path."""
    declare(lib)
    _declare_fwd(lib.decode_attention_fwd_bf16_q)
    lib.decode_attention_plan.argtypes = [_I] * 7 + [_P]
    lib.decode_attention_plan.restype = None
    lib.decode_attention_last_launch.argtypes = [_P]
    lib.decode_attention_last_launch.restype = None
    lib.decode_attention_max_active.argtypes = [_I] * 6
    lib.decode_attention_max_active.restype = _I
    for name in ("decode_attention_threads", "decode_attention_max_group",
                 "decode_attention_max_d"):
        getattr(lib, name).restype = _I
    if (lib.decode_attention_block(), lib.decode_attention_threads(),
            lib.decode_attention_max_group(),
            lib.decode_attention_max_d()) != (CH, THREADS, MAX_GROUP, MAX_D):
        raise RuntimeError("decode_attention.cu and its wrapper disagree on "
                           "the chunk, the threads, the group or the head "
                           "dim")
    for b, h, kv, s, d, bf16, vec in _PLAN_CHECKS:
        out = _PLAN()
        lib.decode_attention_plan(b, h, kv, s, d, bf16, vec, out)
        want = launch_geometry(b, h, kv, s, d,
                               torch.bfloat16 if bf16 else torch.float32,
                               vec=bool(vec)).plan
        if tuple(out) != want:
            raise RuntimeError(f"decode_attention.cu plans {tuple(out)} for "
                               f"{(b, h, kv, s, d)}, bf16={bf16}, "
                               f"vec16={vec}; its wrapper {want}")
    return lib


@dataclass(frozen=True)
class Geometry:
    """One call: a split grid of (ceil(s / CH), kv, b) CTAs of ``THREADS``
    threads, CTA (x, kvh, batch) taking cache positions [x CH, (x + 1) CH)
    of KV head kvh and row batch if any of them is below the row's length,
    then a combine grid of (h, b, ceil(d / COMBINE_COLS)) CTAs.
    ``lengths`` (host integers) are what the counts of work use; without
    them every position is valid.
    16-byte copies when ``vec`` (always for fp32), 8-byte ones otherwise.
    q and the output take ``q_el`` bytes an element (4: fp32, 2: bf16)."""
    b: int
    h: int
    kv: int
    s: int
    d: int
    el: int            # bytes an element of the cache
    vec: bool
    lengths: "tuple[int, ...] | None"
    n_sms: int
    q_el: int = 4

    ch = CH
    threads = THREADS

    @property
    def g(self) -> int:
        return self.h // self.kv

    def valid(self, batch: int) -> int:
        """Cache positions of row ``batch`` that the call reads."""
        if self.lengths is None:
            return self.s
        return max(0, min(self.lengths[batch], self.s))

    def blocks(self, batch: int) -> int:
        """Split CTAs of one (KV head, row) with work: ceil(valid / CH)."""
        return math.ceil(self.valid(batch) / CH)

    @property
    def ctas_x(self) -> int:
        return math.ceil(self.s / CH)

    @property
    def ctas(self) -> int:
        return self.ctas_x * self.kv * self.b

    @property
    def ctas_with_work(self) -> int:
        return self.kv * sum(self.blocks(bb) for bb in range(self.b))

    @property
    def combine_ctas(self) -> int:
        """One a (head, row) and ``COMBINE_COLS`` columns."""
        return self.h * self.b * math.ceil(self.d / COMBINE_COLS)

    @property
    def smem_bytes(self) -> int:
        """K and V rows of a chunk (pitch D el + PAD), q in fp32 (pitch
        4 D + PAD), the score slices of 8 warps (pitch CH + 8) and P (pitch
        round4(G) + 4), as the kernel lays them out."""
        g4 = -(-self.g // 4) * 4
        return (2 * CH * (self.d * self.el + PAD) + self.g * (4 * self.d + PAD)
                + 4 * (THREADS // 32) * self.g * (CH + 8)
                + 4 * CH * (g4 + 4))

    @property
    def ctas_per_sm(self) -> int:
        """Resident split CTAs a SM by shared memory and threads (the
        kernel's launch bounds keep the registers of 2)."""
        return min(2048 // THREADS,
                   SM_SMEM // (self.smem_bytes + CTA_RESERVED))

    @property
    def waves(self) -> int:
        return math.ceil(self.ctas / (self.n_sms * self.ctas_per_sm))

    @property
    def in_flight_per_sm(self) -> int:
        """Bytes a SM has requested at once: each resident CTA's K and V
        rows of a full chunk, all copied at its entry."""
        return 2 * CH * self.d * self.el * self.ctas_per_sm

    @property
    def partial_bytes(self) -> int:
        """(max, sum, accumulator) of each head, written by the CTAs with
        work and read by the combine (L2-resident at these sizes)."""
        return 4 * (self.d + 2) * self.g * self.ctas_with_work

    @property
    def hbm_bytes(self) -> int:
        """Bytes the call must move, each once: the valid K and V rows, q
        read and the output written, the lengths."""
        rows = self.kv * sum(self.valid(bb) for bb in range(self.b))
        return (2 * rows * self.d * self.el
                + 2 * self.q_el * self.b * self.h * self.d + 4 * self.b)

    @property
    def plan(self) -> tuple[int, ...]:
        """As ``decode_attention_plan`` lays it out: split CTAs along S, KV
        and B, threads, shared bytes, copy bytes, combine CTAs."""
        return (self.ctas_x, self.kv, self.b, THREADS, self.smem_bytes,
                16 if self.vec else 8, self.combine_ctas)

    def chunks(self) -> list[tuple[int, int, int, int, int]]:
        """Every (batch, kv head, block, s0, s1) of a split CTA with work:
        cache positions [s0, s1), cut at the row's length."""
        return [(bb, kvh, x, x * CH, min(self.valid(bb), (x + 1) * CH))
                for bb in range(self.b) for kvh in range(self.kv)
                for x in range(self.blocks(bb))]


def _check_shape(b: int, h: int, kv: int, s: int, d: int) -> None:
    if min(b, h, kv, s) < 1 or b > 65535 or kv > 65535:
        raise ValueError(f"decode_attention needs 1 <= B, KV <= 65535 and "
                         f"H, S >= 1, got B={b}, H={h}, KV={kv}, S={s}")
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{h} query heads over {kv} KV heads: the group "
                         f"must divide evenly and be at most {MAX_GROUP}")
    if d % 4 or not 4 <= d <= MAX_D:
        raise ValueError(f"head dim {d} must be a multiple of 4 and at most "
                         f"{MAX_D}")


def _element_size(dtype, what: str) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} must be float32 or bfloat16, got {dtype}")
    return torch.empty((), dtype=dtype).element_size()


def launch_geometry(b: int, h: int, kv: int, s: int, d: int,
                    dtype=torch.float32,
                    lengths: "Sequence[int] | None" = None, *,
                    vec: "bool | None" = None,
                    n_sms: int = 132, q_dtype=torch.float32) -> Geometry:
    """The call for q (b, h, d) of ``q_dtype`` against a (b, s, kv, d) cache
    of ``dtype`` (each fp32 or bf16, either with either) on a card of
    ``n_sms`` SMs. ``lengths``, host integers, give the counts of work and
    bytes. ``vec`` is the copy path: by default the 16-byte one where a row
    is a multiple of 16 bytes, as for a contiguous cache at an aligned
    base; the kernel picks it per call from D, the strides and the base
    addresses. An fp32 row is always 16-byte aligned
    (:func:`decode_attention` admits no other), so fp32 has no 8-byte path.
    q's type changes the bytes of q and the output only: it is held in
    shared memory in fp32 either way."""
    _check_shape(b, h, kv, s, d)
    el = _element_size(dtype, "the cache")
    q_el = _element_size(q_dtype, "q")
    if lengths is not None:
        lengths = tuple(int(x) for x in lengths)
        if len(lengths) != b:
            raise ValueError(f"{len(lengths)} lengths for {b} rows")
    if el == 4 and vec is False:
        raise ValueError("an fp32 cache always takes the 16-byte copies")
    vec = (d * el) % 16 == 0 if vec is None else bool(vec)
    return Geometry(b, h, kv, s, d, el, vec, lengths, n_sms, q_el)


def last_launch() -> tuple[int, ...]:
    """The plan of the kernel's last launch in this process, laid out as
    :attr:`Geometry.plan`."""
    out = _PLAN()
    _lib().decode_attention_last_launch(out)
    return tuple(out)


def max_active(h: int, kv: int, d: int, dtype=torch.float32,
               vec: bool = True,
               device: "torch.device | None" = None, *,
               q_dtype=torch.float32) -> int:
    """Resident split CTAs per SM on the card for a cache of ``dtype`` and
    a q of ``q_dtype``, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    gives them (shared memory, threads and registers); ``vec`` picks a bf16
    cache's copy path (fp32 has the 16-byte one only)."""
    _element_size(dtype, "the cache")
    _element_size(q_dtype, "q")
    device = torch.device("cuda") if device is None else torch.device(device)
    with torch.cuda.device(device):
        n = _lib().decode_attention_max_active(
            h, kv, d, int(dtype == torch.bfloat16), int(vec),
            int(q_dtype == torch.bfloat16))
    if n < 1:
        raise RuntimeError(f"decode_attention occupancy query failed: CUDA "
                           f"error {-n}")
    return n


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention on the card. q: (B,H,D) fp32 or bf16 CUDA,
    contiguous; k, v: (B,S,KV,D) fp32 or bf16 (one type for both, either
    with either q), any strides with the last dim contiguous; lengths: (B,)
    int32 on the same device, never read to the host. Returns (B,H,D) of
    q's type. Differentiable in q, k and v: the backward recomputes
    through :func:`plain` and differentiates that (``autograd.py``)."""
    return recompute(_launch, plain, q, k, v, lengths)


def _launch(q, k, v, lengths) -> torch.Tensor:
    global launches
    out = call(q, k, v, lengths)
    launches += 1
    return out


def call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lengths: torch.Tensor,
         lib: "ctypes.CDLL | None" = None) -> torch.Tensor:
    """:func:`decode_attention` through ``lib``, a build of
    ``decode_attention.cu`` given by :func:`declare` (by default this
    tree's; an older copy to time against it, which takes an fp32 q only),
    counting no launch and recording no gradient."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if (not q.is_cuda or q.dtype not in (torch.float32, torch.bfloat16)
            or not q.is_contiguous()):
        raise ValueError("q must be a contiguous float32 or bfloat16 CUDA "
                         "tensor")
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
    _check_shape(b, h, kv, s, d)
    lib = _lib() if lib is None else lib
    fwd = (lib.decode_attention_fwd if q.dtype == torch.float32
           else lib.decode_attention_fwd_bf16_q)
    ns = math.ceil(s / CH)
    # the partials are fp32 whatever q's type
    m_part, l_part, acc_part = (
        torch.empty(n, dtype=torch.float32, device=q.device)
        for n in (b * h * ns, b * h * ns, b * h * ns * d))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            out.data_ptr(), *k.stride()[:3], *v.stride()[:3], b, h, kv, s, d,
            int(k.dtype == torch.bfloat16), d ** -0.5, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
