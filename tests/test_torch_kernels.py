"""The port's kernels: plain versions against the JAX Pallas kernels
(interpret mode) and their jnp oracles on the CPU, at the shapes and
tolerances of tests/test_kernels.py. The CUDA kernels are held against
their plain versions in test_torch_cuda.py."""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import (ATTN_TOL, MLSTM_TOL, RGLRU_TOL,  # noqa: E402,F401
                           SLSTM_TOL, _reset_port, decode_inputs,
                           flash_inputs, mlstm_inputs, n, rglru_inputs,
                           slstm_inputs, t)

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as jax_decode_attention  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan as jax_mlstm_scan  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.kernels.slstm_scan import slstm_scan as jax_slstm_scan  # noqa: E402
from repro.models.rglru import rglru_scan_ref as jax_rglru_model  # noqa: E402
from repro_torch.kernels import decode_attention as DK  # noqa: E402
from repro_torch.kernels import flash_attention as FK  # noqa: E402
from repro_torch.kernels import mlstm_scan as MK  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as RK  # noqa: E402
from repro_torch.kernels import slstm_scan as SK  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


MLSTM_CASES = [(1, 1, 128, 32, 32), (2, 2, 128, 64, 64),
               (1, 2, 256, 32, 128), (2, 1, 256, 64, 64)]


@pytest.mark.parametrize("b,h,s,d,cs", MLSTM_CASES)
def test_mlstm_plain_matches_jax_kernel(b, h, s, d, cs):
    args = mlstm_inputs(b * 100 + s + d, b, h, s, d)
    got = ops.mlstm_scan(*(t(a) for a in args), cs=cs)
    want = jax_mlstm_scan(*(jnp.asarray(a) for a in args), cs=cs,
                          interpret=True)
    np.testing.assert_allclose(n(got), n(want), **MLSTM_TOL)


@pytest.mark.parametrize("b,h,s,d,cs", MLSTM_CASES)
def test_mlstm_plain_matches_jax_sequential_oracle(b, h, s, d, cs):
    args = mlstm_inputs(b * 100 + s + d + 1, b, h, s, d)
    got = ops.mlstm_scan(*(t(a) for a in args), cs=cs)
    want, _ = jref.mlstm_chunk_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(n(got), n(want), **MLSTM_TOL)


def test_mlstm_sequential_oracle_matches_jax_with_state():
    args = mlstm_inputs(7, 2, 2, 64, 32)
    got, gstate = ref.mlstm_chunk_ref(*(t(a) for a in args))
    want, wstate = jref.mlstm_chunk_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(n(got), n(want), rtol=2e-5, atol=2e-5)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(n(gstate[key]), n(wstate[key]),
                                   rtol=2e-5, atol=2e-5)


SLSTM_CASES = [(1, 1, 64, 32, 32), (2, 2, 64, 64, 64), (1, 2, 128, 32, 64)]


@pytest.mark.parametrize("b,nh,s,hd,cs", SLSTM_CASES)
def test_slstm_plain_matches_jax_kernel(b, nh, s, hd, cs):
    args = slstm_inputs(b * 10 + s + hd, b, nh, s, hd)
    got = ops.slstm_scan(*(t(a) for a in args))
    want = jax_slstm_scan(*(jnp.asarray(a) for a in args), cs=cs,
                          interpret=True)
    np.testing.assert_allclose(n(got), n(want), **SLSTM_TOL)


@pytest.mark.parametrize("b,nh,s,hd,cs", SLSTM_CASES)
def test_slstm_plain_matches_jax_oracle(b, nh, s, hd, cs):
    args = slstm_inputs(b * 10 + s + hd + 1, b, nh, s, hd)
    got = ops.slstm_scan(*(t(a) for a in args))
    want = jref.slstm_scan_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(n(got), n(want), **SLSTM_TOL)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

FLASH_CASES = [  # b, kv, g, s, d, causal, window, dtype
    (1, 1, 4, 128, 64, True, None, "float32"),
    (2, 2, 2, 200, 64, False, None, "float32"),
    (1, 4, 1, 64, 128, True, None, "float32"),
    (2, 1, 2, 256, 64, False, None, "bfloat16"),
    (1, 2, 2, 128, 128, True, None, "bfloat16"),
    (1, 1, 4, 256, 64, True, 64, "float32"),
    # the GQA family's groupings: G=8 over 4 KV heads (yi-9b, qwen2-vl),
    # G=7 over 8 (yi-34b)
    (1, 4, 8, 128, 128, True, None, "float32"),
    (1, 8, 7, 64, 64, True, None, "float32"),
    (1, 4, 8, 64, 64, False, None, "bfloat16"),
    (1, 8, 7, 64, 128, True, None, "bfloat16"),
]


def _cast(arrays, dtype):
    jdt, tdt = _DT[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [t(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("b,kv,g,s,d,causal,window,dtype", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(b, kv, g, s, d, causal, window,
                                        dtype):
    jargs, targs = _cast(flash_inputs(b + s + d, b, kv, g, s, d), dtype)
    got = ops.flash_attention(*targs, causal=causal, window=window)
    want = jax_flash_attention(*jargs, causal=causal, window=window, bq=64,
                               bk=64, interpret=True)
    assert got.dtype == targs[0].dtype and got.shape == (b, kv * g, s, d)
    np.testing.assert_allclose(n(got.float()), n(want.astype(jnp.float32)),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("b,kv,g,s,d,causal,window,dtype", FLASH_CASES)
def test_flash_plain_matches_jax_oracle(b, kv, g, s, d, causal, window,
                                        dtype):
    jargs, targs = _cast(flash_inputs(b + s + d + 1, b, kv, g, s, d), dtype)
    got = ops.flash_attention(*targs, causal=causal, window=window)
    want = jref.flash_attention_ref(*jargs, causal=causal, window=window)
    np.testing.assert_allclose(n(got.float()), n(want.astype(jnp.float32)),
                               **ATTN_TOL[dtype])


def test_flash_plain_reads_strided_views():
    """The model hands (B,H,S,D) views of its (B,S,H,D) projections."""
    q, k, v = flash_inputs(5, 2, 1, 4, 64, 64)
    views = [t(a).transpose(1, 2).contiguous().transpose(1, 2)
             for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = ops.flash_attention(*views, causal=True, window=16)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=True, window=16)
    np.testing.assert_allclose(n(got), n(want), **ATTN_TOL["float32"])


# --------------------------------------------------------------------------
# the flash kernel's arithmetic (3xTF32) and launch geometry (plain, no card)
# --------------------------------------------------------------------------

def _rna_tf32(x):
    """fp32 rounded to 10 mantissa bits, ties away from zero, computed in
    float64 from the exponent (not from the bit pattern)."""
    m, e = np.frexp(np.asarray(x, np.float64))   # |m| in [0.5, 1)
    r = np.floor(np.abs(m) * 2.0 ** 11 + 0.5)    # 11 significant bits
    return (np.sign(m) * r * np.exp2(e - 11)).astype(np.float32)


# x and tf32(x) by hand: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
TF32_TIES = [(1 + 2 ** -11, 1 + 2 ** -10), (-(1 + 2 ** -11), -(1 + 2 ** -10)),
             (1 + 3 * 2 ** -11, 1 + 2 ** -9), (1 + 2 ** -11 - 2 ** -23, 1.0),
             (1 + 2 ** -10, 1 + 2 ** -10), (3 * 2 ** -13, 3 * 2 ** -13),
             (-(2 ** 7) * (1 + 2 ** -11), -(2 ** 7) * (1 + 2 ** -10))]


@pytest.mark.parametrize("x,big", TF32_TIES)
def test_split_tf32_rounds_ties_away_from_zero(x, big):
    b, s = FK.split_tf32(torch.tensor([x], dtype=torch.float32))
    assert b.item() == big
    assert abs(b.item() + s.item() - x) <= 2 ** -21 * abs(x)


def test_split_tf32_rounds_as_cvt_rna_and_keeps_fp32_accuracy():
    rng = np.random.default_rng(17)
    x = (rng.standard_normal(4096)
         * np.exp2(rng.integers(-30, 30, 4096))).astype(np.float32)
    # exact ties: bit 12 set and the 12 bits below it clear (exponents
    # from 2^-97 to 2^97, so that x - big stays a normal number)
    bits = rng.integers(0x0F000000, 0x70000000, 512, dtype=np.uint32)
    ties = ((bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)).view(np.float32)
    x = np.concatenate([x, ties, -ties]).astype(np.float32)
    big, small = (n(a) for a in FK.split_tf32(torch.from_numpy(x)))
    np.testing.assert_array_equal(big, _rna_tf32(x))
    np.testing.assert_array_equal(small, _rna_tf32(x - big))
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(big.astype(np.float64) + small - x)
                  <= 2.0 ** -21 * np.abs(x))
    assert np.all(np.abs(big[-1024:]) > np.abs(x[-1024:]))   # away from 0


@pytest.mark.parametrize("b,kv,g,s,d,causal,window",
                         [c[:7] for c in FLASH_CASES if c[7] == "float32"])
def test_flash_3xtf32_matches_jax_kernel(b, kv, g, s, d, causal, window):
    arrays = flash_inputs(b + s + d, b, kv, g, s, d)
    got = FK.flash_attention_3xtf32(*(t(a) for a in arrays), causal=causal,
                                    window=window)
    want = jax_flash_attention(*(jnp.asarray(a) for a in arrays),
                               causal=causal, window=window, bq=64, bk=64,
                               interpret=True)
    assert got.shape == (b, kv * g, s, d)
    np.testing.assert_allclose(n(got), n(want), **ATTN_TOL["float32"])


# --------------------------------------------------------------------------
# the bf16 instance's arithmetic: P as two bf16 parts (plain, no card)
# --------------------------------------------------------------------------

# x and (hi, lo) by hand. 1 + 2^-9 + 2^-17: hi = 1, the remainder
# 2^-9 (1 + 2^-8) ties between 2^-9 and 2^-9 + 2^-16 and goes to the even
# 2^-9, leaving 2^-17: the bound is reached.
BF16_TIES = [(1 + 2 ** -9 + 2 ** -17, 1.0, 2 ** -9),
             (1 + 2 ** -8, 1.0, 2 ** -8),
             (1 + 3 * 2 ** -8, 1 + 2 ** -6, -(2 ** -8)),
             (1 + 2 ** -8 + 2 ** -20, 1 + 2 ** -7, -(2 ** -8)),
             (0.5, 0.5, 0.0), (0.0, 0.0, 0.0),
             (2 ** -20 * (1 + 2 ** -9 + 2 ** -17), 2 ** -20, 2 ** -29)]


@pytest.mark.parametrize("x,hi,lo", BF16_TIES)
def test_split_bf16_rounds_ties_to_even(x, hi, lo):
    h, l_ = FK.split_bf16(torch.tensor([x], dtype=torch.float32))
    assert (h.item(), l_.item()) == (hi, lo)
    assert abs(x - h.item() - l_.item()) <= 2 ** -17 * abs(x)


def test_split_bf16_keeps_p_within_2_to_minus_17():
    """|P - P_hi - P_lo| <= 2^-17 |P| for P = exp(-x) as the softmax makes
    it, and for exact ties of both roundings; P_hi and P_lo are bf16
    values and P_hi is P rounded to nearest even."""
    rng = np.random.default_rng(26)
    p = np.exp(-rng.exponential(4.0, 8192)).astype(np.float32)
    # ties of P_hi: bit 15 set and the 15 bits below clear; ties of P_lo:
    # a remainder led by bit 14 whose 9th significant bit (bit 6) is set
    # and nothing below, its 8th (bit 7) odd or even
    bits = rng.integers(0x30000000, 0x3F800000, 1024, dtype=np.uint32)
    top = bits & ~np.uint32(0xFFFF)
    ties = [(top | np.uint32(low)).view(np.float32)
            for low in (0x8000, 0x40C0, 0x4040)]
    p = np.concatenate([p, *ties]).astype(np.float32)
    hi, lo = (n(a) for a in FK.split_bf16(torch.from_numpy(p)))
    assert not (hi.view(np.uint32) & 0xFFFF).any()
    assert not (lo.view(np.uint32) & 0xFFFF).any()
    np.testing.assert_array_equal(hi, n(torch.from_numpy(p).to(
        torch.bfloat16).float()))
    err = np.abs(p.astype(np.float64) - hi - lo)
    assert np.all(err <= 2.0 ** -17 * p)
    assert err.max() / p[np.argmax(err)] > 2.0 ** -18   # the bound is near


@pytest.mark.parametrize("b,kv,g,s,d,causal,window",
                         [c[:7] for c in FLASH_CASES])
def test_flash_bf16_2part_matches_jax_kernel(b, kv, g, s, d, causal, window):
    """The bf16 route's arithmetic on bf16 q, k and v against the Pallas
    kernel (interpret mode) on the same bf16 inputs, at the bf16
    tolerance."""
    jargs, targs = _cast(flash_inputs(b + s + d, b, kv, g, s, d), "bfloat16")
    got = FK.flash_attention_bf16_2part(*targs, causal=causal, window=window)
    want = jax_flash_attention(*jargs, causal=causal, window=window, bq=64,
                               bk=64, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (b, kv * g, s, d)
    np.testing.assert_allclose(n(got.float()), n(want.astype(jnp.float32)),
                               **ATTN_TOL["bfloat16"])


@pytest.mark.parametrize("b,kv,g,s,d,causal,window",
                         [c[:7] for c in FLASH_CASES])
def test_flash_bf16_2part_within_limit_of_3xtf32_on_widened_inputs(
        b, kv, g, s, d, causal, window):
    """The bf16 route against the fp32 instance's arithmetic on the bf16
    inputs widened to fp32, unrounded: within ``bf16_limit`` everywhere,
    with most of the limit to spare."""
    q, k, v = (t(a).to(torch.bfloat16)
               for a in flash_inputs(b + s + d + 2, b, kv, g, s, d))
    got = FK.flash_attention_bf16_2part(q, k, v, causal=causal,
                                        window=window)
    wide = FK.flash_attention_3xtf32(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
    share = ((got.float() - wide).abs() / FK.bf16_limit(wide, v)).max()
    assert share <= 1.0
    # the store's rounding alone fills at most half the limit
    assert share <= 0.5 + 2.0 ** -8


@pytest.mark.parametrize("b,kv,g,s,d,causal,window",
                         [c[:7] for c in FLASH_CASES])
def test_flash_bf16_1part_control_exceeds_limit_of_3xtf32(
        b, kv, g, s, d, causal, window):
    """The control: the same arithmetic with P rounded once to bf16 (no
    P_lo, the precision of a route on one bf16 PV product) on the same
    inputs leaves ``bf16_limit`` on every shape, so the limit holds the
    route to two parts and not only to gross faults."""
    q, k, v = (t(a).to(torch.bfloat16)
               for a in flash_inputs(b + s + d + 2, b, kv, g, s, d))
    one = FK.flash_attention_bf16_2part(q, k, v, causal=causal,
                                        window=window, parts=1)
    wide = FK.flash_attention_3xtf32(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
    share = ((one.float() - wide).abs() / FK.bf16_limit(wide, v)).max()
    assert share > 1.0


def test_flash_bf16_2part_takes_one_or_two_parts():
    q, k, v = (t(a).to(torch.bfloat16)
               for a in flash_inputs(0, 1, 1, 2, 16, 64))
    with pytest.raises(ValueError, match="1 or 2 bf16 parts"):
        FK.flash_attention_bf16_2part(q, k, v, parts=3)


def test_bf16_limit_is_one_ulp_plus_a_share_of_v():
    wide = torch.tensor([0.0, 1.0, 1.5, -3.0, 2.0 ** -10])
    v = torch.tensor([[-4.0, 2.0]], dtype=torch.bfloat16)
    want = torch.tensor([0.0, 2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 2.0 ** -17]) \
        + 4 * 2.0 ** -14
    assert torch.equal(FK.bf16_limit(wide, v), want)


FLASH_GEOMETRIES = [  # b, h, kv, sq, skv, d, causal, window
    (1, 16, 1, 4096, 4096, 256, True, 2048),   # RecurrentGemma-9B prefill
    (1, 16, 1, 1100, 1100, 256, True, 300),
    (2, 4, 2, 333, 333, 64, True, 50),
    (2, 4, 4, 200, 200, 64, False, None),
    (1, 4, 1, 500, 500, 128, False, 100),
    (1, 2, 2, 77, 77, 64, False, None),
    (1, 2, 1, 300, 300, 128, True, 5),
    (1, 8, 2, 1000, 700, 128, True, None),     # Sq != Skv
    (1, 32, 4, 4096, 4096, 128, True, None),   # Yi-9B prefill
    (1, 56, 8, 700, 700, 128, True, None)]     # yi-34b's grouping


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window", FLASH_GEOMETRIES)
def test_flash_geometry_walks_heaviest_tiles_first(b, h, kv, sq, skv, d,
                                                   causal, window):
    geo = FK.geometry(b, h, kv, sq, skv, d, causal, window)
    assert geo.tiles == -(-sq // 128) and geo.ctas == geo.tiles * h * b
    assert sorted(geo.order) == list(range(geo.tiles))
    sizes = [hi - lo for lo, hi in map(geo.key_range, geo.order)]
    assert sizes == sorted(sizes, reverse=True)
    # every visible key of a tile lies in the blocks it walks
    i, j = np.arange(sq)[:, None], np.arange(skv)[None, :]
    vis = np.ones((sq, skv), bool)
    if causal:
        vis &= j <= i
    if window is not None:
        vis &= j > i - window
    for tile in range(geo.tiles):
        lo, hi = geo.key_range(tile)
        keys = np.flatnonzero(vis[tile * 128:(tile + 1) * 128].any(0))
        assert np.all((keys >= 32 * lo) & (keys < 32 * hi))


@pytest.mark.parametrize("d", FK.HEAD_DIMS)
def test_flash_tiles_fit_shared_memory(d):
    """The Q tile and one K block at the Q and K row pitch, one V block at
    the V pitch: each the least pitch above d (d + 16 and d + 4 where d is
    a multiple of 32, 80 and 100 at d = 80) at which the kernel's float4
    loads, served a quarter warp at a time, meet no bank twice (QK^T: lane
    (g, t) at word g * pitch + 4t; PV: at 2t * pitch + 4g); at d = 80 the
    PV tail's float2 loads, a half warp at a time, also meet none. Two K
    and two V blocks would not fit at d = 256."""
    qk, vp = FK.pitches(d)
    assert d <= qk < d + 32 and d <= vp < d + 32
    for i in range(4):                       # the quarter warps
        lanes = [(g, tt) for g in (2 * i, 2 * i + 1) for tt in range(4)]
        assert len({(g * qk + 4 * tt) // 4 % 8 for g, tt in lanes}) == 8
        assert len({(2 * tt * vp + 4 * g) // 4 % 8 for g, tt in lanes}) == 8
    if d % 32:                               # the half warps of the tail
        for h in range(2):
            words = {(2 * tt * vp + 32 * (d // 32) + 2 * g) % 32
                     for g in range(4 * h, 4 * h + 4) for tt in range(4)}
            assert len(words) == 16 and all(w % 2 == 0 for w in words)
    if d % 32 == 0:                          # the pitches these dims had
        assert (qk, vp) == (d + 16, d + 4)
    geo = FK.geometry(1, 16, 1, 4096, 4096, d, True, 2048)
    assert geo.smem_bytes == FK.smem_bytes(d) == 4 * (160 * qk + 32 * vp)
    assert geo.smem_bytes <= FK.SMEM_LIMIT == 232448
    assert 4 * (128 * (256 + 16) + 64 * (256 + 16) + 64 * (256 + 4)) \
        > FK.SMEM_LIMIT


def test_flash_geometry_counts_l2_bytes():
    geo = FK.geometry(1, 16, 1, 4096, 4096, 256, True, 2048)
    assert (geo.rows, geo.threads, geo.ctas, geo.waves, geo.smem_bytes) \
        == (128, 256, 512, 4, 207360)
    assert geo.plan == (512, 256, 207360)
    # tile t < 16 walks 4t + 4 blocks of 32 keys, later tiles 68
    blocks = sum(4 * t + 4 for t in range(16)) + 16 * 68
    assert blocks == 1632
    assert geo.key_rows == 16 * 32 * blocks == 835584
    assert geo.l2_bytes == 835584 * 2 * 256 * 4 == 1711276032
    # a ragged tail is copied up to skv only
    small = FK.geometry(1, 2, 1, 77, 77, 64, False, None)
    assert small.key_rows == 2 * 77 and small.l2_bytes == 2 * 77 * 2 * 64 * 4
    assert FK.geometry(1, 16, 1, 4096, 4096, 256, True, 2048, n_sms=132,
                       ctas_per_sm=2).waves == 2


def test_flash_geometry_at_the_yi_9b_shape():
    """Yi-9B's prefill (32 heads over 4 KV heads of 128, S=4096, causal,
    no window): 32 tiles of 128 rows a head, 1024 CTAs, the last tile
    first; tile t walks 4t + 4 key blocks, so each head copies
    32 x 4 x 528 key rows (nothing skipped but the causal upper half)."""
    geo = FK.geometry(1, 32, 4, 4096, 4096, 128, True, None)
    assert (geo.tiles, geo.ctas, geo.smem_bytes) == (32, 1024, 109056)
    assert geo.order == tuple(range(31, -1, -1))
    assert [geo.key_range(t) for t in (0, 31)] == [(0, 4), (0, 128)]
    assert geo.key_rows == 32 * 32 * sum(4 * t + 4 for t in range(32))
    assert geo.plan == (1024, 256, 109056)
    assert FK.geometry(1, 32, 4, 4096, 4096, 128, True, None,
                       ctas_per_sm=2).waves == 4


@pytest.mark.parametrize("d", [16, 96, 192, 512])
def test_flash_geometry_rejects_head_dims(d):
    with pytest.raises(ValueError, match="not one of"):
        FK.geometry(1, 1, 1, 64, 64, d)


# --------------------------------------------------------------------------
# decode attention
# --------------------------------------------------------------------------

DECODE_CASES = [  # b, kv, g, s, d, dtype
    (2, 1, 4, 300, 64, "float32"),
    (3, 2, 4, 128, 128, "bfloat16"),
    (1, 8, 1, 512, 64, "float32"),
    (2, 2, 1, 128, 64, "bfloat16"),
    # G=8 over 4 KV heads (yi-9b, qwen2-vl), G=7 over 8 (yi-34b)
    (2, 4, 8, 300, 128, "float32"),
    (2, 8, 7, 160, 64, "float32"),
    (2, 4, 8, 128, 128, "bfloat16"),
    (1, 8, 7, 300, 128, "bfloat16"),
]


def _decode_args(arrays, dtype):
    q, k, v, lengths = arrays
    jdt, tdt = _DT[dtype]
    jargs = (jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
             jnp.asarray(lengths))
    targs = (t(q).to(tdt), t(k).to(tdt), t(v).to(tdt), t(lengths))
    return jargs, targs


@pytest.mark.parametrize("b,kv,g,s,d,dtype", DECODE_CASES)
def test_decode_plain_matches_jax_kernel(b, kv, g, s, d, dtype):
    jargs, targs = _decode_args(decode_inputs(b + s + d, b, kv, g, s, d),
                                dtype)
    got = ops.decode_attention(*targs)
    want = jax_decode_attention(*jargs, bs=128, interpret=True)
    np.testing.assert_allclose(n(got.float()), n(want.astype(jnp.float32)),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("b,kv,g,s,d,dtype", DECODE_CASES)
def test_decode_plain_matches_jax_oracle(b, kv, g, s, d, dtype):
    jargs, targs = _decode_args(
        decode_inputs(b + s + d + 1, b, kv, g, s, d), dtype)
    got = ops.decode_attention(*targs)
    want = jref.decode_attention_ref(*jargs)
    np.testing.assert_allclose(n(got.float()), n(want.astype(jnp.float32)),
                               **ATTN_TOL[dtype])


def test_decode_plain_takes_a_wider_cache_like_the_model():
    """The model hands an fp32 query and a bf16 cache; JAX casts the cache
    to the activations' type first, which is the same function."""
    q, k, v, lengths = decode_inputs(9, 2, 1, 4, 64, 64)
    kb, vb = (t(a).to(torch.bfloat16) for a in (k, v))
    got = ops.decode_attention(t(q), kb, vb, t(lengths))
    want = jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(n(kb.float())), jnp.asarray(n(vb.float())),
        jnp.asarray(lengths))
    np.testing.assert_allclose(n(got), n(want), **ATTN_TOL["float32"])


def test_decode_plain_gives_zeros_at_length_zero():
    """At length 0 the TPU kernel returns zeros (its oracle gives NaN); the
    port follows the kernel."""
    q, k, v, lengths = decode_inputs(4, 2, 1, 4, 256, 64, lengths=[0, 37])
    got = ops.decode_attention(t(q), t(k), t(v), t(lengths))
    assert torch.all(got[0] == 0)
    want = jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, lengths)),
                                bs=128, interpret=True)
    np.testing.assert_allclose(n(got), n(want), **ATTN_TOL["float32"])
    assert np.isnan(np.asarray(jref.decode_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v, lengths)))[0])).all()


# the decode kernel's launch geometry and its split / combine (plain
# Python, no card)

RG_DECODE = (4, 16, 1, 2048, 256)          # b, h, kv, s, d of RG-9B decode
RG_LENGTHS = (1, 700, 2048, 2048)


@pytest.mark.parametrize("dtype,hbm,smem", [
    (torch.float32, 9_955_344, 106_240), (torch.bfloat16, 5_043_216, 73_472)])
def test_decode_geometry_at_the_recurrentgemma_shape(dtype, hbm, smem):
    """256 split CTAs of 32 positions, 151 with work for lengths (1, 700,
    2048, 2048), at least 2 a SM, one wave on 132 SMs; HBM bytes are the
    valid K and V rows, q, the output and the lengths, each once."""
    geo = DK.launch_geometry(*RG_DECODE, dtype, RG_LENGTHS)
    assert (geo.ch, geo.threads, geo.ctas, geo.ctas_with_work) == \
        (32, 256, 256, 151)
    assert geo.smem_bytes == smem <= DK.SMEM_LIMIT
    assert geo.ctas_per_sm >= 2 and geo.waves == 1
    assert geo.hbm_bytes == hbm == (2 * 4797 * 256 * geo.el
                                    + 8 * 4 * 16 * 256 + 16)
    assert geo.partial_bytes == 4 * 258 * 16 * 151
    assert geo.in_flight_per_sm == 2 * 32 * 256 * geo.el * geo.ctas_per_sm
    assert geo.plan == (64, 1, 4, 256, smem, 16, 256)
    # without lengths every position counts
    full = DK.launch_geometry(*RG_DECODE, dtype)
    assert full.ctas_with_work == 256
    assert full.hbm_bytes == 2 * 4 * 2048 * 256 * geo.el + 8 * 4 * 16 * 256 \
        + 16


def test_decode_geometry_at_the_yi_9b_shape():
    """Yi-9B's decode step (B=4, 32 heads over 4 KV heads of 128, caches
    of 4096): 128 chunks a (KV head, row), 2048 split CTAs, of which those
    up to each row's length have work; P padded to 8 heads exactly."""
    lengths = (1, 1000, 4096, 4096)
    geo = DK.launch_geometry(4, 32, 4, 4096, 128, torch.float32, lengths)
    assert (geo.g, geo.ctas, geo.ctas_with_work) == \
        (8, 2048, 4 * (1 + 32 + 128 + 128))
    assert geo.smem_bytes == (2 * 32 * 528 + 8 * 528 + 4 * 8 * 8 * 40
                              + 4 * 32 * 12) <= DK.SMEM_LIMIT
    assert geo.hbm_bytes == (2 * 4 * (1 + 1000 + 4096 + 4096) * 128 * 4
                             + 8 * 4 * 32 * 128 + 16)
    assert geo.plan == (128, 4, 4, 256, geo.smem_bytes, 16, 4 * 32 * 2)
    # yi-34b's G=7 pads P to 8 heads but keeps 7 score rows
    g7 = DK.launch_geometry(2, 56, 8, 300, 128, torch.bfloat16)
    assert g7.smem_bytes == (2 * 32 * 272 + 7 * 528 + 4 * 8 * 7 * 40
                             + 4 * 32 * 12)


@pytest.mark.parametrize("s", [1, 33, 2049])
@pytest.mark.parametrize("kv", [1, 2])
def test_decode_chunks_cover_every_valid_position_once(s, kv):
    """Ragged S and lengths 0, 1, S and past S: the split CTAs with work
    cover each valid (row, KV head, position) exactly once, each inside one
    chunk of at most CH positions; every other CTA has none."""
    lengths = (0, 1, s, s + 7)
    geo = DK.launch_geometry(len(lengths), 4 * kv, kv, s, 64, torch.float32,
                             lengths)
    seen = np.zeros((len(lengths), kv, s), dtype=np.int32)
    for bb, kvh, x, s0, s1 in geo.chunks():
        assert 0 < s1 - s0 <= geo.ch and s0 == x * geo.ch
        seen[bb, kvh, s0:s1] += 1
    want = np.zeros_like(seen)
    for bb, ln in enumerate(lengths):
        want[bb, :, :min(ln, s)] = 1
    np.testing.assert_array_equal(seen, want)
    assert len(geo.chunks()) == geo.ctas_with_work <= geo.ctas
    assert geo.ctas == math.ceil(s / 32) * kv * len(lengths)


@pytest.mark.parametrize("d,dtype,vec,smem", [
    (68, torch.bfloat16, False, 37_376),    # 136-byte rows: 8-byte copies
    (68, torch.float32, True, 2 * 32 * 288 + 16 * 288 + 20_480 + 2_560),
    (64, torch.bfloat16, True, 2 * 32 * 144 + 16 * 272 + 20_480 + 2_560)])
def test_decode_geometry_picks_the_copy_path_from_the_row(d, dtype, vec,
                                                          smem):
    geo = DK.launch_geometry(1, 16, 1, 100, d, dtype)
    assert geo.vec == vec and geo.smem_bytes == smem
    assert geo.plan[5] == (16 if vec else 8)
    if dtype == torch.float32:   # every fp32 row is 16-byte aligned
        with pytest.raises(ValueError, match="16-byte"):
            DK.launch_geometry(1, 16, 1, 100, d, dtype, vec=False)
    else:
        assert DK.launch_geometry(1, 16, 1, 100, d, dtype,
                                  vec=False).plan[5] == 8


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 7, 8, 16])
def test_decode_geometry_pads_the_group_to_whole_tiles(g):
    """P is kept for round4(G) heads (rows padded by 4), the score slices
    for G (rows of 40)."""
    geo = DK.launch_geometry(2, 2 * g, 2, 64, 64)
    assert geo.smem_bytes == (2 * 32 * 272 + g * 272 + 4 * 8 * g * 40
                              + 4 * 32 * (-(-g // 4) * 4 + 4))
    assert geo.ctas_per_sm >= 2


@pytest.mark.parametrize("shape,match", [
    ((1, 17, 1, 8, 64), "group"), ((1, 6, 4, 8, 64), "group"),
    ((1, 4, 1, 8, 66), "head dim"), ((1, 4, 1, 8, 260), "head dim"),
    ((1, 4, 1, 0, 64), "needs"), ((0, 4, 1, 8, 64), "needs")])
def test_decode_geometry_rejects_shapes(shape, match):
    with pytest.raises(ValueError, match=match):
        DK.launch_geometry(*shape)


def _split_combine(q, k, v, lengths, geo):
    """The kernel's two passes in plain PyTorch at its geometry: each split
    CTA with work gives (max, sum, accumulator) per head over its chunk;
    the combine reads only the blocks a row has and gives zeros without
    any."""
    b, h, d = q.shape
    g = geo.g
    qg = q.float().reshape(b, geo.kv, g, d) * d ** -0.5
    parts = {}
    for bb, kvh, x, s0, s1 in geo.chunks():
        sc = qg[bb, kvh] @ k[bb, s0:s1, kvh].float().T        # (G, n)
        m = sc.max(-1).values
        e = torch.exp(sc - m[:, None])
        parts[bb, kvh, x] = (m, e.sum(-1), e @ v[bb, s0:s1, kvh].float())
    out = torch.zeros(b, h, d)
    for bb in range(b):
        for kvh in range(geo.kv):
            blocks = [parts[bb, kvh, x] for x in range(geo.blocks(bb))]
            if not blocks:
                continue
            m = torch.stack([p[0] for p in blocks])               # (nb, G)
            w = torch.exp(m - m.max(0).values)
            den = (w * torch.stack([p[1] for p in blocks])).sum(0)
            num = (w[..., None] * torch.stack([p[2] for p in blocks])).sum(0)
            out[bb, kvh * g:(kvh + 1) * g] = num / den[:, None]
    return out


@pytest.mark.parametrize("b,kv,g,s,d,dtype", DECODE_CASES + [
    (2, 1, 4, 256, 64, "float32")])
def test_decode_split_combine_matches_jax_kernel(b, kv, g, s, d, dtype):
    """The split / combine at CH = 32 against the TPU kernel (interpret
    mode, 128-position blocks); the last case has a row of length 0, which
    gives zeros."""
    lengths = [0, 37] if s == 256 else None
    q, k, v, ln = decode_inputs(b + s + d + 2, b, kv, g, s, d, lengths)
    jargs, targs = _decode_args((q, k, v, ln), dtype)
    geo = DK.launch_geometry(b, kv * g, kv, s, d, targs[1].dtype, ln)
    got = _split_combine(*targs, geo)
    want = jax_decode_attention(*jargs, bs=128, interpret=True)
    np.testing.assert_allclose(n(got), n(want.astype(jnp.float32)),
                               **ATTN_TOL[dtype])
    if lengths is not None:
        assert torch.all(got[0] == 0)
    np.testing.assert_allclose(n(got),
                               n(ops.decode_attention(*targs).float()),
                               **ATTN_TOL[dtype])


# --------------------------------------------------------------------------
# RG-LRU scan
# --------------------------------------------------------------------------

RGLRU_CASES = [  # b, s, w, with_h0
    (1, 128, 256, False), (2, 256, 512, True), (2, 128, 256, True),
    (1, 256, 256, False)]


def _rglru_args(arrays, lib):
    conv = jnp.asarray if lib == "jax" else t
    return [None if a is None else conv(a) for a in arrays]


@pytest.mark.parametrize("b,s,w,with_h0", RGLRU_CASES)
def test_rglru_plain_matches_jax_kernel(b, s, w, with_h0):
    arrays = rglru_inputs(b + s + w, b, s, w, with_h0)
    y, hl = ops.rglru_scan(*_rglru_args(arrays, "torch"))
    yw, hw = jax_rglru_scan(*_rglru_args(arrays, "jax"), cs=64, bw=128,
                            interpret=True)
    np.testing.assert_allclose(n(y), n(yw), **RGLRU_TOL)
    np.testing.assert_allclose(n(hl), n(hw), **RGLRU_TOL)


@pytest.mark.parametrize("b,s,w,with_h0", RGLRU_CASES)
def test_rglru_plain_matches_jax_oracles(b, s, w, with_h0):
    arrays = rglru_inputs(b + s + w + 1, b, s, w, with_h0)
    y, hl = ops.rglru_scan(*_rglru_args(arrays, "torch"))
    for oracle in (jref.rglru_scan_ref, jax_rglru_model):
        yw, hw = oracle(*_rglru_args(arrays, "jax"))
        np.testing.assert_allclose(n(y), n(yw), **RGLRU_TOL)
        np.testing.assert_allclose(n(hl), n(hw), **RGLRU_TOL)


def test_rglru_plain_decode_step_continues_the_scan():
    """A scan split in two, the second half from the first's last state,
    is the whole scan: the decode step (S = 1, h0 from the cache) rests on
    it."""
    x, ag, ig, lam, _ = rglru_inputs(3, 2, 64, 32, False)
    full, h_full = ref.rglru_scan(t(x), t(ag), t(ig), t(lam))
    y1, h1 = ref.rglru_scan(t(x[:, :40]), t(ag[:, :40]), t(ig[:, :40]),
                            t(lam))
    ys = [y1]
    for i in range(40, 64):
        y_i, h1 = ref.rglru_scan(t(x[:, i:i + 1]), t(ag[:, i:i + 1]),
                                 t(ig[:, i:i + 1]), t(lam), h1)
        ys.append(y_i)
    np.testing.assert_allclose(n(torch.cat(ys, 1)), n(full), **RGLRU_TOL)
    np.testing.assert_allclose(n(h1), n(h_full), **RGLRU_TOL)


# --------------------------------------------------------------------------
# the RG-LRU kernel's launch geometry (plain Python, no card)
# --------------------------------------------------------------------------

def test_rglru_geometry_fills_the_card_in_one_wave():
    """The RecurrentGemma prefill: 128 stripes of 32 channels, one wave on
    132 SMs, a ring of 5 stages of 64 steps and two y tiles that fit a
    CTA's shared memory and keep at least 24 KB in flight a SM; a scan warp
    and 16 workers."""
    geo = RK.geometry(1, 4096, 4096)
    assert (geo.stripe, geo.tile, geo.stages, geo.threads) == (32, 64, 5, 544)
    assert (geo.ctas, geo.n_sms, geo.ctas_per_sm, geo.waves) == \
        (128, 132, 1, 1)
    assert geo.vec and geo.n_tiles == 64
    assert geo.smem_bytes == 4 * (5 * 3 + 2) * 64 * 32 <= RK.SMEM_LIMIT
    assert geo.in_flight_per_sm == 3 * 4 * 3 * 64 * 32 >= 24 * 1024
    assert geo.plan == (128, 1, 544, 139264, 64, 5, 1)


@pytest.mark.parametrize("b,s,w,with_h0,want", [
    (1, 4096, 4096, False, 268_468_224),      # each input read once
    (1, 4096, 4096, True, 268_468_224 + 16_384),
    (4, 1, 4096, True, 4 * 16 * 4096 + 4 * 4096 + 2 * 4 * 4 * 4096),
    (2, 300, 203, False, 16 * 2 * 300 * 203 + 4 * 203 + 4 * 2 * 203)])
def test_rglru_geometry_counts_each_byte_once(b, s, w, with_h0, want):
    """12 B S W read, 4 B S W written, lambda, h_last and h0 once each:
    268.5 MB at the prefill shape, where the two-pass kernel moved ~470."""
    geo = RK.geometry(b, s, w, with_h0=with_h0)
    assert geo.hbm_bytes == want == (12 * b * s * w + 4 * b * s * w + 4 * w
                                     + 4 * b * w + 4 * b * w * with_h0)


@pytest.mark.parametrize("b,s,w", [
    (2, 300, 200), (1, 65, 203), (4, 1, 4096), (1, 4097, 96), (3, 9, 5),
    (2, 64, 32), (1, 130, 33)])
def test_rglru_tiles_cover_every_step_and_channel_once(b, s, w):
    """Ragged S (a partial last tile) and W (a partial last stripe), and
    the decode step, are covered exactly once, each block inside one tile
    of one stripe."""
    geo = RK.geometry(b, s, w)
    seen = np.zeros((b, s, w), dtype=np.int32)
    for bb, t0, t1, w0, w1 in geo.tiles():
        assert 0 < t1 - t0 <= geo.tile and 0 < w1 - w0 <= geo.stripe
        seen[bb, t0:t1, w0:w1] += 1
    assert (seen == 1).all()
    assert len(geo.tiles()) == geo.ctas * geo.n_tiles


@pytest.mark.parametrize("b,s,w,vec,plan", [
    (4, 1, 4096, True, (128, 4, 64, 640, 1, 1, 1)),     # the decode step
    (2, 300, 200, True, (7, 2, 544, 139264, 64, 5, 1)),
    (2, 300, 203, False, (7, 2, 544, 139264, 64, 5, 0)),  # 4-byte copies
    (1, 65, 256, True, (8, 1, 544, 65536, 64, 2, 1)),    # two tiles
    (1, 20, 64, True, (2, 1, 192, 12800, 20, 1, 1)),     # one short tile
    (1, 4097, 4096, True, (128, 1, 544, 139264, 64, 5, 1))])
def test_rglru_geometry_shrinks_for_short_launches(b, s, w, vec, plan):
    """The tile shrinks to S, the ring to the tiles there are and the
    workers to one warp for every 4 steps of a tile; rows of W not a
    multiple of 4 take the 4-byte path."""
    geo = RK.geometry(b, s, w)
    assert geo.vec == vec and geo.plan == plan
    assert geo.threads % 32 == 0 and 64 <= geo.threads <= RK.MAX_THREADS
    assert geo.smem_bytes == 4 * (3 * geo.stages + 2) * geo.tile * 32
    assert RK.geometry(b, s, w, vec=False).plan == plan[:-1] + (0,)


@pytest.mark.parametrize("b,s,w", [(0, 8, 32), (1, 0, 32), (1, 8, 0),
                                   (65536, 1, 32)])
def test_rglru_geometry_rejects_empty_shapes(b, s, w):
    with pytest.raises(ValueError, match="rglru_scan needs"):
        RK.geometry(b, s, w)


# --------------------------------------------------------------------------
# the sLSTM kernel's launch geometry (plain Python, no card)
# --------------------------------------------------------------------------

SLSTM_GEOMETRIES = [(8, 4, 192, 32), (8, 4, 192, 30), (8, 4, 192, 16),
                    (3, 4, 256, 12), (1, 1, 64, 1), (2, 2, 128, 132),
                    (16, 4, 192, 20), (5, 3, 16, 2)]


@pytest.mark.parametrize("b,nh,hd,active", SLSTM_GEOMETRIES)
def test_slstm_geometry_covers_every_chain_once(b, nh, hd, active):
    geo = SK.geometry(b, nh, hd, active)
    served = [pair for c in range(geo.n_clusters) for pair in geo.chains(c)]
    assert sorted(served) == [(bb, h) for bb in range(b) for h in range(nh)]
    assert all(geo.chains(c) for c in range(geo.n_clusters))
    assert geo.grid == geo.cl * geo.n_clusters


@pytest.mark.parametrize("hd,cl", [(16, 4), (64, 4), (128, 4), (144, 8),
                                   (192, 8), (208, 8), (256, 8)])
def test_slstm_geometry_splits_units_across_the_cluster(hd, cl):
    geo = SK.geometry(2, 2, hd, 8)
    assert geo.cl == cl
    owned = [u for rank in range(geo.cl) for u in geo.units_of(rank)]
    assert owned == list(range(hd))
    # 16 threads a unit (four gates, a sixteenth of K each), whole warps,
    # each holding at most 64 values of R
    assert geo.threads == 16 * hd // cl and geo.threads % 32 == 0
    assert 4 * hd * (hd // cl) <= 64 * geo.threads


@pytest.mark.parametrize("b,nh,active,rb", [
    (8, 4, 32, 1), (8, 4, 31, 2), (8, 4, 16, 2), (8, 4, 15, 3),
    (8, 4, 8, 4), (8, 4, 4, 4), (8, 4, 1, 4), (3, 4, 12, 1), (3, 4, 8, 2),
    (1, 1, 1, 1), (20, 1, 2, 4), (16, 4, 30, 3), (2, 4, 4, 2)])
def test_slstm_geometry_takes_the_smallest_rows_that_fit(b, nh, active, rb):
    geo = SK.geometry(b, nh, 192, active)
    assert geo.rb == rb
    fits = [r for r in range(1, min(b, SK.MAX_ROWS) + 1)
            if nh * -(-b // r) <= active]
    if fits:
        assert geo.n_clusters <= active and rb == fits[0]
    else:                        # nothing fits: the most rows, in waves
        assert rb == min(b, SK.MAX_ROWS)


@pytest.mark.parametrize("hd", [0, 8, 24, 100, 200, 264, 272, 512])
def test_slstm_geometry_rejects_head_dims(hd):
    with pytest.raises(ValueError, match="multiple of 16 up to 256"):
        SK.geometry(2, 2, hd, 32)
    with pytest.raises(ValueError, match="multiple of 16 up to 256"):
        SK.cluster_size(hd)


# --------------------------------------------------------------------------
# the mLSTM kernel's launch geometry (plain Python, no card)
# --------------------------------------------------------------------------

def _per_sm(n):
    """Resident CTAs per SM, the same ``n`` for every tile width."""
    return dict.fromkeys(MK.TILE_WIDTHS, n)


@pytest.mark.parametrize("b,h,d,n_sms,per_sm,dv,grid,waves", [
    (8, 4, 384, 132, 1, 96, 128, 1),     # xLSTM-125M prefill: one full wave
    (1, 4, 384, 132, 1, 32, 48, 1),      # small batch: the narrowest tile
    (2, 4, 384, 132, 1, 32, 96, 1),
    (3, 4, 384, 132, 1, 64, 72, 1),      # 32 would need 144 CTAs
    (16, 4, 384, 132, 1, 96, 256, 2),    # no tile fits one wave
    (8, 4, 384, 132, {32: 2, 64: 1, 96: 1}, 96, 128, 1),
    (4, 4, 384, 132, {32: 2, 64: 1, 96: 1}, 32, 192, 1),
    (2, 2, 64, 132, 1, 32, 8, 1),
    (64, 4, 64, 132, 1, 64, 256, 2),     # D=64: 96 does not divide it
    (1, 1, 512, 132, 1, 32, 16, 1)])     # only 32 fits shared memory
def test_mlstm_geometry_takes_the_narrowest_tile_in_one_wave(
        b, h, d, n_sms, per_sm, dv, grid, waves):
    per = per_sm if isinstance(per_sm, dict) else _per_sm(per_sm)
    geo = MK.geometry(b, h, d, n_sms, per)
    assert (geo.dv, geo.grid, geo.waves) == (dv, grid, waves)
    assert d % geo.dv == 0 and geo.smem_bytes <= MK.SMEM_LIMIT
    assert geo.threads == MK.THREADS == 512
    resident = [w for w in MK.tile_widths(d)
                if b * h * (d // w) <= n_sms * per[w]]
    if resident:                 # the narrowest tile that is resident
        assert geo.dv == resident[0] and geo.waves == 1
    else:                        # none is: the widest that fits, in waves
        assert geo.dv == MK.tile_widths(d)[-1] and geo.waves > 1


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 448, 512])
def test_mlstm_tile_widths_divide_the_head_dim_and_fit(d):
    widths = MK.tile_widths(d)
    assert widths and widths == sorted(widths)
    assert all(d % w == 0 and MK.smem_bytes(d, w) <= MK.SMEM_LIMIT
               for w in widths)
    for b, h in ((1, 1), (8, 4), (64, 8)):
        assert d % MK.geometry(b, h, d, 132, _per_sm(1)).dv == 0
    # the xLSTM tile: C 384x96 with 16 v rows, q|W padded, two regions
    # that take turns holding k (padded) and the partial sums, n and 7
    # gate vectors
    assert MK.smem_bytes(384, 96) == 4 * (400 * 96 + 16 * 404
                                          + 2 * 16 * 388 + 384 + 7 * 16)


@pytest.mark.parametrize("d", [0, 32, 96, 100, 576, 640])
def test_mlstm_geometry_rejects_head_dims(d):
    with pytest.raises(ValueError, match="multiple of 64"):
        MK.geometry(2, 2, d, 132, _per_sm(1))


def test_mlstm_geometry_needs_a_resident_tile():
    with pytest.raises(ValueError, match="resident"):
        MK.geometry(2, 2, 384, 132, _per_sm(0))


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _all_launches():
    return (MK.launches, SK.launches, RK.launches, FK.launches, DK.launches)


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    before = _all_launches()
    ops.mlstm_scan(*(t(a) for a in mlstm_inputs(0, 1, 1, 64, 64)), cs=32)
    ops.slstm_scan(*(t(a) for a in slstm_inputs(0, 1, 1, 8, 32)))
    ops.rglru_scan(*(t(a) for a in rglru_inputs(0, 1, 8, 32, True)))
    ops.flash_attention(*(t(a) for a in flash_inputs(0, 1, 1, 2, 16, 64)))
    ops.decode_attention(*(t(a) for a in decode_inputs(0, 1, 1, 2, 16, 64)))
    assert _all_launches() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version themselves: a CPU
    tensor is an error there (the dispatch in ops picks the plain one)."""
    with pytest.raises(ValueError, match="CUDA"):
        MK.mlstm_scan(*(t(a) for a in mlstm_inputs(0, 1, 1, 64, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        SK.slstm_scan(*(t(a) for a in slstm_inputs(0, 1, 1, 8, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        RK.rglru_scan(*(t(a) for a in rglru_inputs(0, 1, 8, 32, True)))
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_attention(*(t(a) for a in flash_inputs(0, 1, 1, 2, 16, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        DK.decode_attention(*(t(a) for a in decode_inputs(0, 1, 1, 2, 16,
                                                          64)))


def _grad_inputs(kernel):
    """CPU inputs of one CUDA wrapper; every float input requires grad."""
    args = {"mlstm_scan": lambda: mlstm_inputs(0, 1, 2, 64, 64),
            "slstm_scan": lambda: slstm_inputs(0, 2, 1, 8, 32),
            "rglru_scan": lambda: rglru_inputs(0, 2, 8, 32, True),
            "flash_attention": lambda: flash_inputs(0, 1, 1, 2, 16, 64),
            "decode_attention": lambda: decode_inputs(0, 2, 1, 2, 16,
                                                      64)}[kernel]()
    args = [t(a) for a in args]
    return [a.requires_grad_(True) if a.is_floating_point() else a
            for a in args]


_WRAPPERS = {"mlstm_scan": MK.mlstm_scan, "slstm_scan": SK.slstm_scan,
             "rglru_scan": RK.rglru_scan,
             "flash_attention": FK.flash_attention,
             "decode_attention": DK.decode_attention}
_PLAIN = {"mlstm_scan": MK.plain, "slstm_scan": SK.plain,
          "rglru_scan": RK.plain, "flash_attention": FK.plain,
          "decode_attention": DK.plain}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _grads_by_plain_autograd(kernel, args, grad_outs):
    """Gradients of the plain version by autograd alone, from fresh copies
    of ``args``."""
    fresh = [a.detach().clone().requires_grad_(a.requires_grad) for a in args]
    outs = _outputs(_PLAIN[kernel](*fresh))
    return torch.autograd.grad(outs, [a for a in fresh if a.requires_grad],
                               grad_outs)


@pytest.mark.parametrize("forward", ["plain", "perturbed"])
@pytest.mark.parametrize("kernel", sorted(_WRAPPERS))
def test_kernel_backward_is_plain_autograd(kernel, forward):
    """The shared helper with a stand-in forward on the CPU (the plain
    version, or its result moved by 1): the output carries a grad_fn and
    every input's grad equals plain autograd's bit for bit, whatever the
    forward returned. The CUDA wrapper itself still refuses CPU tensors,
    with grad and without, and launches nothing."""
    from repro_torch.kernels.autograd import recompute
    plain = _PLAIN[kernel]

    def stand_in(*a):
        out = plain(*a)
        if forward == "plain":
            return out
        return tuple(o + 1 for o in out) if isinstance(out, tuple) \
            else out + 1

    args = _grad_inputs(kernel)
    outs = _outputs(recompute(stand_in, plain, *args))
    assert all(o.grad_fn is not None for o in outs)
    rng = np.random.default_rng(1)
    grad_outs = [torch.from_numpy(rng.standard_normal(o.shape)
                                  .astype(np.float32)) for o in outs]
    got = torch.autograd.grad(outs, [a for a in args if a.requires_grad],
                              grad_outs)
    want = _grads_by_plain_autograd(kernel, args, grad_outs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)

    before = _all_launches()
    with pytest.raises(ValueError, match="CUDA"):
        _WRAPPERS[kernel](*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _WRAPPERS[kernel](*args)
    assert _all_launches() == before


def test_recompute_gives_no_grad_to_absent_inputs():
    """rglru_scan without h0: None passes through the helper, both outputs
    carry grads back to x, the gates and lambda."""
    from repro_torch.kernels.autograd import recompute
    x, ag, ig, lam, _ = [None if a is None else t(a).requires_grad_(True)
                         for a in rglru_inputs(2, 2, 8, 16, False)]
    y, h_last = recompute(RK.plain, RK.plain, x, ag, ig, lam, None)
    (y.sum() + 2 * h_last.sum()).backward()
    fresh = [a.detach().clone().requires_grad_(True) for a in (x, ag, ig, lam)]
    y2, h2 = RK.plain(*fresh, None)
    (y2.sum() + 2 * h2.sum()).backward()
    for a, b in zip((x, ag, ig, lam), fresh):
        assert torch.equal(a.grad, b.grad)


def test_unknown_kernel_impl_raises():
    with pytest.raises(ValueError, match="kernel_impl"):
        ops.mlstm_scan(*(t(a) for a in mlstm_inputs(0, 1, 1, 64, 64)),
                       kernel_impl="pallas")
