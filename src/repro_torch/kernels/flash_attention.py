"""Flash attention forward (GQA, causal and window masks): the CUDA
kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention.py`` (the Pallas TPU
kernel). The kernel is ``csrc/flash_attention.cu``; its plain PyTorch
version is :func:`repro_torch.kernels.ref.flash_attention`. The kernel
reads q, k and v through their strides, so the model hands it (B,H,S,D)
views of its (B,S,H,D) projections without a copy, and the output keeps
q's layout. The TPU kernel's block arguments (``bq``, ``bk``,
``interpret``) are gone: the kernel uses its own tiles.

It takes q, k and v in fp32 or in bf16 (all three of one type) and
returns q's type, ``ROWS`` query rows of one head a CTA; :func:`geometry`
is its launch in plain Python. The fp32 instance computes both products on
TF32 tensor cores in split precision (3xTF32); :func:`split_tf32` and
:func:`flash_attention_3xtf32` are its arithmetic in plain PyTorch. The
bf16 instance computes them on bf16 tensor cores with P kept as two bf16
parts; :func:`split_bf16` and :func:`flash_attention_bf16_2part` are its
arithmetic. Its sums run in another order than the fp32 instance's, so
against the fp32 instance on the widened inputs it is held within
:func:`bf16_limit`, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import _build
from .autograd import recompute
from .ref import flash_attention as plain

__all__ = ["flash_attention", "plain", "launches", "bind", "Geometry",
           "geometry", "launch_geometry", "last_launch", "smem_bytes",
           "split_tf32", "split_bf16", "bf16_ulp", "bf16_limit", "DTYPES",
           "flash_attention_3xtf32", "flash_attention_bf16_2part",
           "HEAD_DIMS", "ROWS", "KEY_BLOCK", "THREADS", "SMEM_LIMIT",
           "pitches",
           "BF16_TWO_CTAS_MAX_D", "BF16_STRIDE_LIMIT"]

#: kernel launches made by :func:`flash_attention` in this process
launches = 0

#: head dims the kernel is built for
HEAD_DIMS = (64, 80, 128, 256)
#: input types the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)
#: the bf16 instance's pad (elements) after each shared Q, K and V row
BF16_PAD = 8
#: query rows a CTA, as ``flash_attention_rows``
ROWS = 128
#: keys a block of the loop, as ``flash_attention_key_block`` (both types)
KEY_BLOCK = 32
#: threads a CTA, as ``flash_attention_threads``
THREADS = 256
#: the bf16 instance's launch bounds ask registers for 2 CTAs a SM at head
#: dims up to this one (1 above it; the fp32 instance's for 1)
BF16_TWO_CTAS_MAX_D = 128
#: shared memory one CTA may take on the card
SMEM_LIMIT = 232448
#: bf16 row strides lie below this many elements, as ``BF16_STRIDE_LIMIT``
#: in the kernel: its copies take row x stride (row < ``ROWS``) in 32 bits
BF16_STRIDE_LIMIT = 2 ** 24

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_geometries: dict[tuple, "Geometry"] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``flash_attention.cu`` (the
    plain one, or one with extra defines) and check that it agrees with
    this module's constants."""
    for name in ("flash_attention_fwd", "flash_attention_fwd_bf16"):
        getattr(lib, name).argtypes = ([_P] * 4 + [_L] * 12 + [_I] * 8
                                       + [ctypes.c_float, _P])
        getattr(lib, name).restype = _I
    for name in ("flash_attention_max_active", "flash_attention_smem_bytes"):
        getattr(lib, name).argtypes = [_I, _I]
        getattr(lib, name).restype = _I
    for name in ("flash_attention_rows", "flash_attention_key_block",
                 "flash_attention_threads"):
        getattr(lib, name).restype = _I
    lib.flash_attention_last_launch.argtypes = [_P]
    lib.flash_attention_last_launch.restype = None
    if ((lib.flash_attention_rows(), lib.flash_attention_key_block(),
         lib.flash_attention_threads()) != (ROWS, KEY_BLOCK, THREADS)
            or any(lib.flash_attention_smem_bytes(d, el) != smem_bytes(d, el)
                   for d in HEAD_DIMS for el in (4, 2))):
        raise RuntimeError("flash_attention.cu and its wrapper disagree on "
                           "the rows, the key block, the threads or shared "
                           "memory")
    return lib


def pitches(d: int, el: int = 4) -> tuple[int, int]:
    """Row pitches in elements of the shared Q and K rows and of the V rows
    for elements of ``el`` bytes, as the kernel lays them out. fp32: the
    least pitches above d at 16 and at 4 words mod 32 (``qk_pitch_f32``,
    ``v_pitch_f32``: d + 16 and d + 4 at d = 64, 128, 256; 80 and 100 at
    d = 80), so that the quarter-warp float4 loads of QK^T and PV meet no
    bank twice; bf16: d + 8 for all three (d / 2 + 4 words, an odd multiple
    of 4, so ldmatrix's 8 rows of 16 bytes meet no bank twice)."""
    if el == 2:
        return d + BF16_PAD, d + BF16_PAD
    return d + (16 - d) % 32, d + (4 - d) % 32


def smem_bytes(d: int, el: int = 4) -> int:
    """Shared memory of one CTA for elements of ``el`` bytes (4: fp32, 2:
    bf16), as ``flash_attention_smem_bytes`` in the kernel: the Q tile and
    one K block at the Q and K pitch, one V block at the V pitch
    (:func:`pitches`)."""
    qk, vp = pitches(d, el)
    return el * ((ROWS + KEY_BLOCK) * qk + KEY_BLOCK * vp)


def _element_size(dtype) -> int:
    if dtype not in DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{dtype}")
    return torch.empty((), dtype=dtype).element_size()


@dataclass(frozen=True)
class Geometry:
    """One launch's layout: ``ctas`` CTAs of ``THREADS`` threads, each on
    ``ROWS`` query rows of one head, the q tiles in ``order`` (each tile's
    H x B heads together), and the key blocks each walks; ``el`` is the
    bytes of an input element (4: fp32, 2: bf16)."""
    b: int
    h: int
    kv: int
    sq: int
    skv: int
    d: int
    causal: bool
    window: "int | None"
    n_sms: int
    ctas_per_sm: int   # resident CTAs per SM
    el: int = 4

    rows = ROWS
    threads = THREADS

    @property
    def tiles(self) -> int:
        return math.ceil(self.sq / ROWS)

    @property
    def ctas(self) -> int:
        return self.tiles * self.h * self.b

    @property
    def waves(self) -> int:
        return math.ceil(self.ctas / (self.n_sms * self.ctas_per_sm))

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.d, self.el)

    @property
    def plan(self) -> tuple[int, int, int]:
        """As the kernel records its launch: CTAs, threads, shared
        bytes."""
        return (self.ctas, THREADS, self.smem_bytes)

    @property
    def order(self) -> tuple[int, ...]:
        """q tiles in launch order, as ``tile_at_rank`` in the kernel: the
        most key blocks first, ties in order, the last tile first under a
        causal mask (where later rows see more keys)."""
        def key(tile):
            lo, hi = self.key_range(tile)
            return lo - hi, -tile if self.causal else tile
        return tuple(sorted(range(self.tiles), key=key))

    def key_range(self, tile: int) -> tuple[int, int]:
        """Key blocks [lo, hi) that tile walks, as the kernel bounds them:
        those with a key visible to some row of the tile."""
        q0 = tile * ROWS
        lo, hi = 0, math.ceil(self.skv / KEY_BLOCK)
        if self.causal:
            hi = min(hi, (min(q0 + ROWS, self.sq) - 1) // KEY_BLOCK + 1)
        if self.window is not None:
            lo = max(0, q0 - self.window + 1) // KEY_BLOCK
        return lo, max(lo, hi)

    @property
    def key_rows(self) -> int:
        """K (and V) rows the launch copies from L2: each CTA's key blocks,
        cut at skv."""
        per_head = sum(min(hi * KEY_BLOCK, self.skv) - lo * KEY_BLOCK
                       for lo, hi in map(self.key_range, range(self.tiles))
                       if hi > lo)
        return per_head * self.h * self.b

    @property
    def l2_bytes(self) -> int:
        """Bytes of K and V the launch reads from L2 (rows of d
        elements)."""
        return self.key_rows * 2 * self.d * self.el


def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")


def geometry(b: int, h: int, kv: int, sq: int, skv: int, d: int,
             causal: bool = True, window: "int | None" = None, *,
             n_sms: int = 132, ctas_per_sm: "int | None" = None,
             dtype=torch.float32) -> Geometry:
    """The launch for q (b,h,sq,d) against k, v (b,kv,skv,d) of ``dtype``
    (fp32 or bf16) on a card of ``n_sms`` SMs holding ``ctas_per_sm`` CTAs
    each (by default the count the instance's launch bounds ask registers
    for: 2 for bf16 up to ``BF16_TWO_CTAS_MAX_D``, else 1)."""
    _check_head_dim(d)
    el = _element_size(dtype)
    if ctas_per_sm is None:
        ctas_per_sm = 2 if el == 2 and d <= BF16_TWO_CTAS_MAX_D else 1
    if min(b, h, kv, sq, skv, n_sms) < 1 or h % kv:
        raise ValueError(f"flash_attention needs b, h, kv, sq, skv, n_sms "
                         f">= 1 and h a multiple of kv, got {b}, {h}, {kv}, "
                         f"{sq}, {skv}, {n_sms}")
    return Geometry(b, h, kv, sq, skv, d, bool(causal), window, n_sms,
                    ctas_per_sm, el)


def launch_geometry(b: int, h: int, kv: int, sq: int, skv: int, d: int,
                    causal: bool = True, window: "int | None" = None,
                    device: "torch.device | None" = None,
                    dtype=torch.float32) -> Geometry:
    """:func:`geometry` with the card's SM count and its resident CTAs per
    SM for ``dtype``'s instance, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them."""
    _check_head_dim(d)
    el = _element_size(dtype)
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if (d, el, index) not in _geometries:
        with torch.cuda.device(index):
            per_sm = _lib().flash_attention_max_active(d, el)
        if per_sm < 1:
            raise RuntimeError(f"flash_attention occupancy query failed: "
                               f"CUDA error {-per_sm}")
        n_sms = torch.cuda.get_device_properties(index).multi_processor_count
        _geometries[d, el, index] = geometry(1, 1, 1, 1, 1, d, n_sms=n_sms,
                                             ctas_per_sm=per_sm, dtype=dtype)
    card = _geometries[d, el, index]
    return geometry(b, h, kv, sq, skv, d, causal, window, n_sms=card.n_sms,
                    ctas_per_sm=card.ctas_per_sm, dtype=dtype)


def last_launch() -> tuple[int, int, int]:
    """The kernel's last launch in this process, laid out as
    :attr:`Geometry.plan`."""
    out = (ctypes.c_int * 3)()
    _lib().flash_attention_last_launch(out)
    return tuple(out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: "int | None" = None) -> torch.Tensor:
    """Attention on the card. q: (B,H,Sq,D); k, v: (B,KV,Skv,D), CUDA,
    all three fp32 or all three bf16, any strides with the last dim
    contiguous and 16-byte aligned rows (in bf16 less than 2^24 elements
    apart); H a multiple of KV; D in
    ``HEAD_DIMS``. Returns (B,H,Sq,D) of q's type in q's layout; in bf16,
    within :func:`bf16_limit` of the fp32 kernel's result on the widened
    inputs.
    Differentiable: the backward recomputes through :func:`plain` and
    differentiates that (``autograd.py``)."""
    return recompute(
        functools.partial(_launch, causal=causal, window=window),
        functools.partial(plain, causal=causal, window=window), q, k, v)


def _check_rows(name: str, t: torch.Tensor, el: int) -> None:
    """Raise unless the kernel can copy ``t``'s rows of ``el``-byte
    elements: a contiguous last dim, 16-byte aligned rows and, in bf16, a
    row stride below ``BF16_STRIDE_LIMIT``."""
    if (t.stride(3) != 1 or any(st * el % 16 for st in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(f"{name} needs a contiguous last dim and "
                         f"16-byte aligned rows")
    if el == 2 and t.stride(2) >= BF16_STRIDE_LIMIT:
        raise ValueError(f"{name}'s rows lie {t.stride(2)} elements apart: "
                         f"the bf16 kernel takes row strides below 2^24")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: "int | None") -> torch.Tensor:
    global launches
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    el = _element_size(q.dtype)
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, kv, skv, d)),
                           ("v", v, (b, kv, skv, d))):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q {q.dtype}: the kernel "
                             f"takes q, k and v of one type")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        _check_rows(name, t, el)
    if h % kv:
        raise ValueError(f"{h} query heads do not split over {kv} KV heads")
    _check_head_dim(d)
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    out = torch.empty_like(q)          # keeps q's strides
    lib = _lib()
    fwd = lib.flash_attention_fwd if el == 4 else lib.flash_attention_fwd_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, h, kv, sq, skv, d, int(causal),
            0 if window is None else window, d ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """(big, small) with big + small ~ x: ``big`` is fp32 ``x`` rounded to
    TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero, 10
    mantissa bits; on the int32 view ``(bits + 0x1000) & ~0x1FFF``) and
    ``small`` is ``x - big`` rounded the same way."""
    x = x.float()
    big = _round_tf32(x)
    return big, _round_tf32(x - big)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three fp32 products of TF32 parts, summed in the order the
    kernel issues them: small.big, big.small, then big.big."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return (torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small)
            + torch.matmul(a_big, b_big))


def flash_attention_3xtf32(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: "int | None" = None) -> torch.Tensor:
    """:func:`plain` with both products in split precision: S = QK^T and
    PV each as three products of TF32 parts (big.big + big.small +
    small.big, fp32 sums), P = exp(S - max) split after the exponent and
    normalised after PV, as the kernel does. Any device."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, d).float()
    logits = _matmul_3xtf32(qg, k.float()[:, :, None].transpose(-1, -2)) \
        * (d ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    top = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isinf(top), 0.0, top))
    l_sum = p.sum(-1, keepdim=True)
    out = _matmul_3xtf32(p, v.float()[:, :, None])
    out = torch.where(l_sum > 0, out / torch.where(l_sum > 0, l_sum, 1.0),
                      0.0)
    return out.reshape(b, h, sq, d).to(q.dtype)


def split_bf16(x: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """(hi, lo) as fp32 tensors of bf16 values, as the bf16 instance splits
    P: ``hi`` is fp32 ``x`` rounded to bf16 (to nearest, ties to even) and
    ``lo`` the remainder ``x - hi`` (exact in fp32) rounded the same way, so
    that ``|x - hi - lo| <= 2**-17 * |x|`` for normal values."""
    x = x.float()
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def flash_attention_bf16_2part(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: "int | None" = None,
                               parts: int = 2) -> torch.Tensor:
    """:func:`plain` as the bf16 instance computes it: S = QK^T of the bf16
    q and k summed in fp32 (the products are exact), P = exp(S - max) in
    fp32 split as :func:`split_bf16`, PV = P_lo V + P_hi V in fp32 (the
    small product first), normalised by the fp32 sum of P after PV and
    rounded to q's type. Any device. ``parts=1`` drops P_lo (P rounded once
    to bf16, as a route on one bf16 PV product would): the control that
    :func:`bf16_limit` rejects."""
    if parts not in (1, 2):
        raise ValueError(f"P is kept in 1 or 2 bf16 parts, not {parts}")
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, d).float()
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) \
        * (d ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    top = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isinf(top), 0.0, top))
    l_sum = p.sum(-1, keepdim=True)
    p_hi, p_lo = split_bf16(p)
    vf = v.float()[:, :, None]
    out = torch.matmul(p_hi, vf)
    if parts == 2:
        out = torch.matmul(p_lo, vf) + out
    out = torch.where(l_sum > 0, out / torch.where(l_sum > 0, l_sum, 1.0),
                      0.0)
    return out.reshape(b, h, sq, d).to(q.dtype)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of |x| (8 significant bits: 2^(floor(log2|x|) - 7)),
    0 where x is 0."""
    _, e = torch.frexp(x.abs().float())          # |x| = m 2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 0.0, ulp)


def bf16_limit(wide: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The elementwise limit on ``|got - wide|`` for the bf16 instance's
    output ``got`` against ``wide``, the fp32 instance's unrounded output
    on the same inputs widened to fp32: one bf16 ulp of ``|wide|`` (the
    store's rounding, half an ulp of a result that lies beside ``wide``)
    plus ``2**-14 * max|v|`` (P_lo's dropped bits, at most 2^-17 of each P,
    and the fp32 sums taken in another order, with 8x or more to spare)."""
    return bf16_ulp(wide) + 2.0 ** -14 * v.float().abs().max()
