"""The CUDA kernels against their plain versions on the card. Needs a
CUDA device and nvcc, not JAX; skips without a card. On the GPU host (whose
Python has no JAX for tests/conftest.py to import):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch
from _torch_parity import (ATTN_TOL, MLSTM_TOL, RGLRU_TOL,  # noqa: F401
                           SLSTM_TOL, _reset_port, chip_smoke, cuda_device,
                           decode_inputs, flash_inputs, mlstm_b_i_scales,
                           mlstm_inputs, n, rglru_inputs, slstm_inputs, t)

from repro_torch.kernels import decode_attention as DK
from repro_torch.kernels import flash_attention as FK
from repro_torch.kernels import mlstm_scan as MK
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as RK
from repro_torch.kernels import slstm_scan as SK


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,h,s,d,dv", [
    (2, 2, 256, 64, 32), (1, 4, 512, 384, 32), (3, 4, 512, 384, 64),
    (8, 4, 256, 384, 96), (2, 2, 128, 192, 32), (1, 2, 64, 512, 32),
    (2, 2, 48, 128, 32),     # S a multiple of 16, not of 32
    (2, 2, 48, 64, 32),
    (1, 1, 16, 64, 32),      # one chunk
    (8, 4, 2048, 384, 96)])  # the xLSTM-125M prefill shape
def test_mlstm_kernel_matches_plain_on_card(cuda_device, b, h, s, d, dv):
    """One case per column tile; the plain version walks chunks of up to
    256 rows, the kernel 16."""
    args = [t(a, cuda_device) for a in mlstm_inputs(3, b, h, s, d)]
    assert MK.launch_geometry(b, h, d, cuda_device).dv == dv
    before = MK.launches
    got = ops.mlstm_scan(*args)
    torch.cuda.synchronize()
    assert MK.launches == before + 1
    want = MK.plain(*args, cs=256)
    np.testing.assert_allclose(n(got), n(want), **MLSTM_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,h,d", [(8, 4, 384), (1, 4, 384), (2, 2, 64)])
def test_mlstm_launch_geometry_on_card(cuda_device, b, h, d):
    """The card's SM count and occupancy pick the column tile; the xLSTM
    shape runs in one wave."""
    geo = MK.launch_geometry(b, h, d, cuda_device)
    assert geo.ctas_per_sm >= 1
    assert geo.n_sms == torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    if (b, h, d) == (8, 4, 384):
        assert (geo.dv, geo.grid, geo.waves) == (96, 128, 1)


@pytest.mark.requires_cuda
def test_mlstm_kernel_rejects_sequence_off_the_chunk(cuda_device):
    args = [t(a, cuda_device) for a in mlstm_inputs(0, 1, 1, 40, 64)]
    before = MK.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        MK.mlstm_scan(*args)
    assert MK.launches == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,nh,s,hd", [
    (2, 2, 128, 64), (2, 4, 256, 192),
    (8, 4, 512, 192),        # the model's width and batch
    (1, 1, 64, 64),          # a single cluster
    (3, 4, 96, 256),         # eight CTAs a cluster, odd batch
    (2, 2, 128, 128), (2, 3, 40, 16), (2, 1, 33, 208), (1, 2, 1, 48),
    (20, 4, 48, 192)])       # more clusters than the card holds at once
def test_slstm_kernel_matches_plain_on_card(cuda_device, b, nh, s, hd):
    args = [t(a, cuda_device) for a in slstm_inputs(3, b, nh, s, hd)]
    before = SK.launches
    got = ops.slstm_scan(*args)
    torch.cuda.synchronize()
    assert SK.launches == before + 1
    np.testing.assert_allclose(n(got), n(SK.plain(*args)), **SLSTM_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,nh,hd", [(8, 4, 192), (3, 4, 256), (64, 4, 192)])
def test_slstm_launch_geometry_on_card(cuda_device, b, nh, hd):
    """The card's count of resident clusters picks the rows per cluster."""
    geo = SK.launch_geometry(b, nh, hd, cuda_device)
    assert geo.max_active_clusters >= 1
    assert geo == SK.geometry(b, nh, hd, geo.max_active_clusters)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [40, 264])
def test_slstm_kernel_rejects_unsupported_head_dim(cuda_device, hd):
    args = [t(a, cuda_device) for a in slstm_inputs(0, 1, 1, 8, hd)]
    before = SK.launches
    with pytest.raises(ValueError, match="multiple of 16 up to 256"):
        ops.slstm_scan(*args)
    assert SK.launches == before


@pytest.mark.requires_cuda
def test_mlstm_kernel_rejects_unsupported_head_dim(cuda_device):
    args = [t(a, cuda_device) for a in mlstm_inputs(0, 1, 1, 64, 32)]
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.mlstm_scan(*args)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,w,with_h0", [
    (2, 128, 256, False), (2, 300, 200, True), (4, 1, 4096, True),
    (1, 4096, 4096, False),
    (2, 300, 203, True),      # rows not 16-byte aligned: 4-byte copies
    (1, 203, 203, False),
    (1, 65, 256, True),       # a last tile of one step
    (1, 4097, 4096, False),   # the same, at the prefill width
    (3, 9, 5, True),          # one short tile, a stripe of 5 channels
    (1, 4096, 4096, True)])   # the prefill shape from a state
def test_rglru_kernel_matches_plain_on_card(cuda_device, b, s, w, with_h0):
    args = [None if a is None else t(a, cuda_device)
            for a in rglru_inputs(3, b, s, w, with_h0)]
    before = RK.launches
    y, hl = ops.rglru_scan(*args)
    torch.cuda.synchronize()
    assert RK.launches == before + 1
    assert RK.last_launch()[-1] == (w % 4 == 0)   # the copy path
    yw, hw = RK.plain(*args)
    np.testing.assert_allclose(n(y), n(yw), **RGLRU_TOL)
    np.testing.assert_allclose(n(hl), n(hw), **RGLRU_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,w,offset", [
    (1, 4096, 4096, 0), (4, 1, 4096, 0), (2, 300, 203, 0), (1, 65, 256, 0),
    (2, 300, 200, 1)])        # W a multiple of 4, base 4 bytes off 16
def test_rglru_launch_geometry_on_card(cuda_device, b, s, w, offset):
    """The kernel launches what launch_geometry says: CTAs, threads, shared
    memory, tile, stages and copy path, the last from W and the base
    addresses; the prefill shape is one wave."""
    arrays = rglru_inputs(5, b, s, w, True)
    args = []
    for a in arrays:
        buf = torch.zeros(a.size + offset, device=cuda_device)
        buf[offset:] = t(a.ravel(), cuda_device)
        args.append(buf[offset:].view(a.shape))
    geo = RK.launch_geometry(b, s, w, aligned=offset == 0, with_h0=True,
                             device=cuda_device)
    assert geo.n_sms == torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert geo.ctas_per_sm >= 1
    before = RK.launches
    y, hl = ops.rglru_scan(*args)
    torch.cuda.synchronize()
    assert RK.launches == before + 1
    assert RK.last_launch() == geo.plan
    assert geo.vec == (w % 4 == 0 and offset == 0)
    if (b, s, w) == (1, 4096, 4096):
        assert (geo.ctas, geo.waves) == (128, 1)
    yw, hw = RK.plain(*args)
    np.testing.assert_allclose(n(y), n(yw), **RGLRU_TOL)
    np.testing.assert_allclose(n(hl), n(hw), **RGLRU_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,kv,g,s,d,causal,window", [
    (1, 1, 16, 512, 256, True, 128), (2, 2, 2, 200, 64, False, None),
    (1, 4, 1, 256, 128, True, None), (2, 1, 4, 333, 64, True, 50),
    (1, 1, 16, 1100, 256, True, 300),    # RecurrentGemma's heads, ragged
    (1, 2, 2, 300, 128, True, 5),        # a window inside one key block
    (2, 2, 2, 130, 256, True, None),     # Sq past the 128-row tile by 2
    (1, 1, 2, 77, 64, False, None),      # non-causal, no window
    (1, 4, 8, 1000, 128, True, None),    # yi-9b's grouping, no window
    (1, 8, 7, 300, 128, True, None),     # yi-34b's
    (1, 16, 1, 1000, 128, True, None),   # qwen2-moe's and deepseek-moe's
    (2, 4, 8, 200, 64, False, None),
    (2, 16, 1, 300, 80, False, None),    # hubert-xlarge's, S ragged
    (1, 2, 2, 130, 80, True, 48)])       # D=80 under a causal window
def test_flash_kernel_matches_plain_on_card(cuda_device, b, kv, g, s, d,
                                            causal, window):
    q, k, v = (t(a, cuda_device) for a in flash_inputs(3, b, kv, g, s, d))
    before = FK.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.launches == before + 1
    assert FK.last_launch() == FK.launch_geometry(
        b, kv * g, kv, s, s, d, causal, window, cuda_device).plan
    want = FK.plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(n(got), n(want), **ATTN_TOL["float32"])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_flash_launch_geometry_on_card(cuda_device, d):
    """The card's occupancy gives the CTAs per SM; at D=256 one CTA of 128
    rows fills an SM's shared memory."""
    geo = FK.launch_geometry(1, 16, 1, 4096, 4096, d, True, 2048,
                             cuda_device)
    assert geo.ctas_per_sm >= 1
    assert geo.n_sms == torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert geo == FK.geometry(1, 16, 1, 4096, 4096, d, True, 2048,
                              n_sms=geo.n_sms, ctas_per_sm=geo.ctas_per_sm)
    if d == 256:
        assert geo.ctas_per_sm == 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_flash_bf16_launch_geometry_on_card(cuda_device, d):
    """The bf16 instance holds as many CTAs a SM as its launch bounds ask
    registers for (2 up to D=128, 1 at D=256), as the plain geometry
    says."""
    geo = FK.launch_geometry(1, 56, 8, 4096, 4096, d, True, None,
                             cuda_device, dtype=torch.bfloat16)
    assert geo == FK.geometry(1, 56, 8, 4096, 4096, d, True, None,
                              n_sms=geo.n_sms, dtype=torch.bfloat16)


@pytest.mark.requires_cuda
def test_flash_kernel_reads_strided_views_on_card(cuda_device):
    """(B,H,S,D) views of (B,S,H,D) tensors, as the model passes them; the
    output keeps q's layout."""
    q, k, v = (t(a, cuda_device).transpose(1, 2).contiguous().transpose(1, 2)
               for a in flash_inputs(4, 2, 1, 4, 160, 128))
    got = ops.flash_attention(q, k, v, causal=True, window=64)
    assert got.stride() == q.stride()
    want = FK.plain(q, k, v, causal=True, window=64)
    np.testing.assert_allclose(n(got), n(want), **ATTN_TOL["float32"])


@pytest.mark.requires_cuda
def test_flash_bf16_kernel_reads_rows_far_apart_on_card(cuda_device):
    """bf16 q, k and v whose rows lie just under ``FK.BF16_STRIDE_LIMIT``
    (2^24) elements apart, in a 4 GiB buffer of 128 such rows: the Q tile's
    last rows lie near 2^31 elements past its first. The output equals, bit
    for bit, the kernel's on contiguous copies; rows 2^24 apart are
    refused."""
    s, d, stride = 128, 128, FK.BF16_STRIDE_LIMIT - 8
    buf = torch.empty(s * FK.BF16_STRIDE_LIMIT, dtype=torch.bfloat16,
                      device=cuda_device)
    rows = buf[:s * stride].view(s, stride)
    rng = np.random.default_rng(7)
    rows[:, :3 * d] = t(rng.standard_normal((s, 3 * d), dtype=np.float32),
                        cuda_device).to(torch.bfloat16)
    q, k, v = (rows[None, None, :, i * d:(i + 1) * d] for i in range(3))
    assert q.stride(2) == stride and stride * (s - 16) >= 2 ** 30
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    torch.cuda.synchronize()
    far = buf.view(s, FK.BF16_STRIDE_LIMIT)[None, None, :, :d]
    with pytest.raises(ValueError, match="below 2\\^24"):
        ops.flash_attention(far, k, v, causal=True)
    del buf, rows, q, k, v, far
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    torch.cuda.empty_cache()


_BF16_CASES = {  # the flash cases: b, kv, g, s, d, causal, window
    "flash-rg": (1, 1, 16, 512, 256, True, 128),
    "flash-ragged": (2, 1, 4, 333, 64, True, 50),
    "flash-yi-9b": (1, 4, 8, 1000, 128, True, None),
    "flash-yi-34b": (1, 8, 7, 1000, 128, True, None),   # G=7, D=128
    "flash-g1": (1, 16, 1, 300, 128, True, None),
    "flash-noncausal": (2, 2, 2, 130, 256, False, None),
    "flash-hubert": (2, 16, 1, 300, 80, False, None),   # D=80, non-causal
}
# the decode cases: b, kv, g, s, d, lengths, the cache's type (q is bf16)
_BF16_DECODE_CASES = {
    "decode-yi-34b-bf16-cache": (4, 8, 7, 4096, 128, [1, 1000, 4096, 4096],
                                 "bfloat16"),
    "decode-yi-34b-fp32-cache": (2, 8, 7, 300, 128, [300, 77], "float32"),
    "decode-rg-bf16-cache": (4, 1, 16, 2048, 256, [1, 700, 2048, 2048],
                             "bfloat16"),
    "decode-8-byte-rows": (2, 1, 16, 200, 68, [200, 0], "bfloat16"),
    "decode-g1-fp32-cache": (3, 16, 1, 100, 64, [100, 1, 33], "float32"),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(_BF16_CASES) + sorted(
    _BF16_DECODE_CASES))
def test_bf16_kernel_is_fp32_kernel_on_widened_inputs_on_card(cuda_device,
                                                              case):
    """Each kernel on bf16 inputs (flash: q, k and v; decode: q, on a bf16
    or an fp32 cache) returns bf16 within the bf16 tolerance of its plain
    version, and against its fp32 kernel on the inputs widened to fp32:
    decode equal bit for bit to it rounded to bf16 (the bf16 q is widened
    on its load); flash, whose bf16 route sums in another order and keeps
    P as two bf16 parts, within ``FK.bf16_limit`` of it unrounded."""
    bf = torch.bfloat16
    if case in _BF16_CASES:
        b, kv, g, s, d, causal, window = _BF16_CASES[case]
        q, k, v = (t(a, cuda_device).to(bf)
                   for a in flash_inputs(5, b, kv, g, s, d))
        before = FK.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert FK.launches == before + 1
        assert FK.last_launch() == FK.launch_geometry(
            b, kv * g, kv, s, s, d, causal, window, cuda_device,
            dtype=bf).plan
        wide = ops.flash_attention(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
        want = FK.plain(q, k, v, causal=causal, window=window)
    else:
        b, kv, g, s, d, lengths, cache = _BF16_DECODE_CASES[case]
        qn, kn, vn, ln = decode_inputs(5, b, kv, g, s, d, lengths)
        cdt = getattr(torch, cache)
        q = t(qn, cuda_device).to(bf)
        k, v = (t(a, cuda_device).to(cdt) for a in (kn, vn))
        ln = t(ln, cuda_device)
        before = DK.launches
        got = ops.decode_attention(q, k, v, ln)
        torch.cuda.synchronize()
        assert DK.launches == before + 1
        assert DK.last_launch() == DK.launch_geometry(
            b, kv * g, kv, s, d, cdt, lengths, q_dtype=bf).plan
        wide = ops.decode_attention(q.float(), k, v, ln)
        want = DK.plain(q, k, v, ln)
    assert got.dtype == bf and wide.dtype == torch.float32
    if case in _BF16_CASES:
        assert ((got.float() - wide).abs()
                <= FK.bf16_limit(wide, v)).all()
    else:
        assert torch.equal(got.view(torch.int16),
                           wide.to(bf).view(torch.int16))
    np.testing.assert_allclose(n(got.float()), n(want.float()),
                               **ATTN_TOL["bfloat16"])


@pytest.mark.requires_cuda
def test_bf16_kernels_refuse_mixed_or_unaligned_inputs_on_card(cuda_device):
    """flash_attention takes q, k and v of one type with 16-byte aligned
    rows; a bf16 row of D=64 from a view that starts 4 elements in is
    not."""
    q, k, v = (t(a, cuda_device).to(torch.bfloat16)
               for a in flash_inputs(0, 1, 1, 2, 64, 64))
    with pytest.raises(ValueError, match="one type"):
        ops.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    wide = torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16,
                       device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(wide[..., 4:], k, v)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,kv,g,s,d,lengths", [
    (4, 1, 16, 2048, 256, [1, 700, 2048, 2048]),
    (2, 2, 4, 300, 128, [0, 299]), (3, 8, 1, 100, 64, None),
    (2, 1, 16, 2049, 256, [2049, 33]),   # a partial last chunk
    (1, 1, 16, 1, 256, [1]),             # one position
    (3, 1, 4, 512, 128, [512, 512, 512]),  # every length is S
    (2, 1, 16, 200, 68, [200, 77]),      # bf16 rows of 136 B: 8-byte copies
    (2, 2, 16, 300, 64, None),
    (4, 4, 8, 4096, 128, [1, 1000, 4096, 4096]),   # a Yi-9B decode step
    (2, 8, 7, 300, 128, [300, 77]),      # yi-34b's G=7: P padded to 8
    (4, 16, 1, 4096, 128, [1, 1000, 4096, 4096]),  # qwen2-moe's G=1
    (3, 8, 7, 33, 64, [1, 33, 32]),
    (2, 2, 4, 100, 64, [150, 100])])     # a length past S counts as S
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, b, kv, g, s,
                                             d, lengths):
    q, k, v, ln = decode_inputs(3, b, kv, g, s, d, lengths)
    tdt = getattr(torch, dtype)
    args = (t(q, cuda_device), t(k, cuda_device).to(tdt),
            t(v, cuda_device).to(tdt), t(ln, cuda_device))
    before = DK.launches
    got = ops.decode_attention(*args)
    torch.cuda.synchronize()
    assert DK.launches == before + 1
    assert DK.last_launch()[5] == (16 if d * args[1].element_size() % 16 == 0
                                   else 8)
    want = DK.plain(*args)
    np.testing.assert_allclose(n(got), n(want), **ATTN_TOL[dtype])
    if lengths is not None and lengths[0] == 0:
        assert torch.all(got[0] == 0)
    if lengths is not None and max(lengths) > s:
        capped = t(np.minimum(ln, s), cuda_device)
        assert torch.equal(got, ops.decode_attention(*args[:3], capped))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,lengths", [
    (4, 16, 1, 2048, 256, (1, 700, 2048, 2048)),
    (2, 16, 1, 200, 68, (200, 0)), (3, 8, 2, 33, 64, (33, 1, 32)),
    (4, 32, 4, 4096, 128, (1, 1000, 4096, 4096)),   # Yi-9B, G=8
    (2, 56, 8, 300, 128, (300, 77))])               # yi-34b, G=7
def test_decode_launch_geometry_on_card(cuda_device, dtype, b, h, kv, s, d,
                                        lengths):
    """The kernel launches what launch_geometry says: split CTAs, threads,
    shared memory, copy path and combine CTAs; the card's occupancy is at
    least the 2 CTAs a SM that one wave at the RecurrentGemma shape
    needs."""
    tdt = getattr(torch, dtype)
    q, k, v, ln = decode_inputs(4, b, kv, h // kv, s, d, lengths)
    args = (t(q, cuda_device), t(k, cuda_device).to(tdt),
            t(v, cuda_device).to(tdt), t(ln, cuda_device))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    geo = DK.launch_geometry(b, h, kv, s, d, tdt, lengths, n_sms=sms)
    before = DK.launches
    got = DK.decode_attention(*args)
    torch.cuda.synchronize()
    assert DK.launches == before + 1
    assert DK.last_launch() == geo.plan
    per_sm = DK.max_active(h, kv, d, tdt, geo.vec, cuda_device)
    assert 2 <= per_sm <= geo.ctas_per_sm
    if (b, s, d) == (4, 2048, 256):
        assert (geo.ctas, geo.ctas_with_work, geo.waves) == (256, 151, 1)
        assert per_sm == geo.ctas_per_sm
    np.testing.assert_allclose(n(got), n(DK.plain(*args)), **ATTN_TOL[dtype])


@pytest.mark.requires_cuda
def test_decode_kernel_replays_in_a_cuda_graph_with_new_lengths(cuda_device):
    """One call captured in a CUDA graph reads the lengths on the device:
    replayed after they change in place, it gives the new result, so no
    call reads them to the host."""
    q, k, v, ln = (t(a, cuda_device)
                   for a in decode_inputs(6, 3, 1, 16, 300, 256,
                                          [300, 5, 0]))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        DK.decode_attention(q, k, v, ln)          # builds and warms up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DK.decode_attention(q, k, v, ln)
    for lengths in ([300, 5, 0], [1, 0, 299], [33, 300, 64]):
        ln.copy_(torch.tensor(lengths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_allclose(n(out), n(DK.plain(q, k, v, ln)),
                                   **ATTN_TOL["float32"])
        for row, length in enumerate(lengths):
            if length == 0:
                assert torch.all(out[row] == 0)


# --------------------------------------------------------------------------
# on the card: the kernels' backward and the train step through them
# --------------------------------------------------------------------------

_BACKWARD_CASES = {
    "mlstm_scan": (MK, lambda: mlstm_inputs(4, 2, 2, 256, 64)),
    "slstm_scan": (SK, lambda: slstm_inputs(4, 2, 2, 64, 64)),
    "rglru_scan": (RK, lambda: rglru_inputs(4, 2, 64, 128, True)),
    "flash_attention": (FK, lambda: flash_inputs(4, 1, 1, 2, 128, 64)),
    "decode_attention": (DK, lambda: decode_inputs(4, 2, 1, 2, 64, 64)),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel", sorted(_BACKWARD_CASES))
def test_kernel_backward_is_plain_autograd_on_card(cuda_device, kernel):
    """Under grad each wrapper launches its kernel once in the forward and
    not at all in the backward, and each input's grad equals autograd's
    through the plain version at the same inputs and grad_output (the
    same operations on the same inputs; at most 1e-6 relative, for
    atomics in index backward)."""
    mod, make = _BACKWARD_CASES[kernel]
    args = [t(a, cuda_device) for a in make()]
    args = [a.requires_grad_(True) if a.is_floating_point() else a
            for a in args]
    before = mod.launches
    out = getattr(mod, kernel)(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.grad_fn is not None for o in outs)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    grad_outs = [torch.randn(o.shape, generator=gen, device=cuda_device)
                 for o in outs]
    got = torch.autograd.grad(outs, [a for a in args if a.requires_grad],
                              grad_outs)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    fresh = [a.detach().clone().requires_grad_(a.requires_grad)
             for a in args]
    ref = mod.plain(*fresh)
    want = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,),
                               [a for a in fresh if a.requires_grad],
                               grad_outs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert (g - w).abs().max().item() <= 1e-6 * w.abs().max().item()


@pytest.mark.requires_cuda
def test_train_step_with_kernels_matches_plain_on_card(cuda_device):
    """Smoke xLSTM at S=512 (mLSTM head dim 64, sLSTM head dim 32): one
    train step's loss and grads with the kernels against the plain path,
    to chip_smoke.py phase 5's limits; the kernels launch in the forward
    only (2 mlstm_scan, 1 slstm_scan)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synth_batch
    from repro_torch.models import Model
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import leaves, map_with_path

    cfg = get_arch("xlstm-125m", smoke=True)
    params = Model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             synth_batch(cfg, batch=2, seq=512, seed=0, step=0).items()}
    runs = {}
    for impl in ("hopper", "plain"):
        MK.launches = SK.launches = 0
        runs[impl] = value_and_grad(Model(cfg, kernel_impl=impl), params,
                                     batch)
        torch.cuda.synchronize()
        runs[impl + " launches"] = (MK.launches, SK.launches)
    assert runs["hopper launches"] == (2, 1)
    assert runs["plain launches"] == (0, 0)
    (loss, _), grads = runs["hopper"]
    (want_loss, _), want = runs["plain"]
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    names = []
    map_with_path(lambda path, _: names.append(path), params)
    scale_of = mlstm_b_i_scales(cfg, names)
    want_by = dict(zip(names, leaves(want)))
    for name, g, w in zip(names, leaves(grads), leaves(want)):
        scale = want_by[scale_of.get(name, name)].abs().max().item()
        assert (g - w).abs().max().item() <= 1e-3 * scale, name


@pytest.mark.requires_cuda
def test_narrow_gqa_model_with_kernels_matches_plain_on_card(cuda_device):
    """A narrow GQA model at Yi's head shape (2 attn layers, 16 heads over
    2 KV heads of 128, G=8): the prefill launches flash_attention once a
    layer and its logits agree with the plain path; 8 decode steps launch
    decode_attention once a layer each and agree with the plain path's
    steps, and the last with the prefill."""
    from repro_torch.configs import ArchConfig
    from repro_torch.models import Model

    cfg = ArchConfig(name="gqa-narrow", family="dense", n_layers=2,
                     d_model=256, n_heads=16, n_kv_heads=2, head_dim=128,
                     d_ff=512, vocab_size=512, rope_theta=1e4)
    params = Model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 200))).to(cuda_device)
    kern, plain = Model(cfg), Model(cfg, kernel_impl="plain")
    FK.launches = DK.launches = 0
    with torch.no_grad():
        got, _ = kern.apply(params, {"tokens": toks})
        torch.cuda.synchronize()
        assert (FK.launches, DK.launches) == (2, 0)
        want, _ = plain.apply(params, {"tokens": toks})
    assert (FK.launches, DK.launches) == (2, 0)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale
    caches = [m.init_cache(2, max_seq=16, device=cuda_device,
                           dtype=torch.float32) for m in (kern, plain)]
    for i in range(8):
        DK.launches = 0
        step_k, caches[0] = kern.decode_step(params, caches[0],
                                             toks[:, i:i + 1])
        torch.cuda.synchronize()
        assert DK.launches == 2
        step_p, caches[1] = plain.decode_step(params, caches[1],
                                              toks[:, i:i + 1])
        assert (step_k - step_p).abs().max().item() <= 1e-4 * scale
    with torch.no_grad():
        short, _ = plain.apply(params, {"tokens": toks[:, :8]})
    assert (step_k[:, 0] - short[:, -1]).abs().max().item() <= 1e-3 * scale


@pytest.mark.requires_cuda
def test_narrow_hubert_model_with_kernels_matches_plain_on_card(cuda_device):
    """A narrow HuBERT at its head shape (2 attn layers, 4 heads of 80,
    non-causal, the audio frontend): the forward launches flash_attention
    once a layer and its logits agree with the plain path's within 1e-4 of
    the largest; the eval loss the same."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train import make_eval_step

    cfg = dataclasses.replace(get_arch("hubert-xlarge"), n_layers=2,
                              d_model=320, n_heads=4, n_kv_heads=4,
                              head_dim=80, d_ff=640, vocab_size=64)
    params = Model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    rng = np.random.default_rng(0)
    batch = {"frames": t(rng.standard_normal((2, 300, cfg.frontend_dim),
                                             dtype=np.float32), cuda_device),
             "labels": t(rng.integers(0, cfg.vocab_size, size=(2, 300)),
                         cuda_device)}
    kern, plain = Model(cfg), Model(cfg, kernel_impl="plain")
    FK.launches = 0
    with torch.no_grad():
        got, _ = kern.apply(params, batch)
        torch.cuda.synchronize()
        assert FK.launches == 2
        want, _ = plain.apply(params, batch)
    assert FK.launches == 2
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale
    loss_k = make_eval_step(kern)(params, batch)["loss"].item()
    loss_p = make_eval_step(plain)(params, batch)["loss"].item()
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)


@pytest.mark.requires_cuda
def test_narrow_bf16_model_is_its_widened_kernel_path_on_card(cuda_device,
                                                              monkeypatch):
    """A narrow bf16 attn model at Yi-34B's head shape (2 layers, 14 heads
    over 2 KV heads of 128, G=7): its prefill (one flash_attention launch a
    layer on bf16 q, k and v) lies within the 1-ulp yardstick of the same
    prefill with each flash_attention call's inputs widened to fp32 and its
    output rounded back (the yardstick: that widened prefill with the
    embeddings moved by one bf16 ulp, ``chip_smoke.one_ulp_moved``); its
    decode steps (bf16 q on a bf16 and on an fp32 cache) equal bit for bit
    those with each decode_attention call's q widened and its output
    rounded back."""
    from repro_torch.configs import ArchConfig
    from repro_torch.models import Model

    bf = torch.bfloat16
    cfg = ArchConfig(name="gqa-narrow-bf16", family="dense", n_layers=2,
                     d_model=256, n_heads=14, n_kv_heads=2, head_dim=128,
                     d_ff=512, vocab_size=512, rope_theta=1e4)
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        device=cuda_device, dtype=bf)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 200))).to(cuda_device)
    flash, decode = ops.flash_attention, ops.decode_attention

    def widened_flash(q, k, v, **kw):
        return flash(q.float(), k.float(), v.float(), **kw).to(q.dtype)

    def widened_decode(q, k, v, lengths, **kw):
        return decode(q.float(), k, v, lengths, **kw).to(q.dtype)

    def decode_8(cache_dtype):
        cache = model.init_cache(2, max_seq=16, device=cuda_device,
                                 dtype=cache_dtype)
        return [model.decode_step(params, cache, toks[:, i:i + 1])[0]
                for i in range(8)]

    with torch.no_grad():
        FK.launches = DK.launches = 0
        got, _ = model.apply(params, {"tokens": toks})
        torch.cuda.synchronize()
        assert (FK.launches, DK.launches) == (2, 0)
        steps = {c: decode_8(c) for c in (bf, torch.float32)}
        assert DK.launches == 2 * 8 * 2
        monkeypatch.setattr(ops, "flash_attention", widened_flash)
        monkeypatch.setattr(ops, "decode_attention", widened_decode)
        want, _ = model.apply(params, {"tokens": toks})
        alt, _ = model.apply(chip_smoke().one_ulp_moved(params),
                             {"tokens": toks})
        for c, got_steps in steps.items():
            for g_, w_ in zip(got_steps, decode_8(c)):
                assert torch.equal(g_, w_)
    moved = (alt - want).abs().max().item()
    assert torch.isfinite(got).all() and moved > 0
    assert (got - want).abs().max().item() <= moved


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-moe-16b"])
def test_moe_apply_on_card_matches_cpu(cuda_device, arch):
    """The smoke MoE layer at B=2, S=64 on the card against the CPU, with
    its own capacity factor and with 0.5, which drops: the same routing
    (indices and drop mask), y within 1e-5 and the aux loss."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe as MOE

    smoke = get_arch(arch, smoke=True).moe
    p = MOE.moe_init(torch.Generator().manual_seed(0), smoke)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, smoke.d_model)).astype(np.float32))
    for dims in (smoke, dataclasses.replace(smoke, capacity_factor=0.5)):
        pc = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor)
                  else {kk: vv.to(cuda_device) for kk, vv in v.items()})
              for k, v in p.items()}
        want_r = MOE.route(p["router"], x, dims)
        got_r = MOE.route(pc["router"], x.to(cuda_device), dims)
        assert torch.equal(got_r.gate_idx.cpu(), want_r.gate_idx)
        assert torch.equal(got_r.within.cpu(), want_r.within)
        want, want_aux = MOE.moe_apply(p, x, dims)
        got, aux = MOE.moe_apply(pc, x.to(cuda_device), dims)
        np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.requires_cuda
def test_narrow_mla_model_on_card_matches_cpu(cuda_device):
    """A narrow MLA model at MiniCPM3's head shape (2 mla layers, 8 heads,
    q.k at 64 + 32 dims, v at 64, latents r_q 128 and r_kv 64) on the card
    against the same parameters on the CPU: the prefill's logits within
    1e-4 of the largest, then 8 absorbed decode steps on 6-slot fp32
    caches (the last two writes dropped past the end), each within 1e-4,
    with the final caches; no kernel launches on the card."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.mla import MLADims
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(
        get_arch("minicpm3-4b"), n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=8, d_ff=512, vocab_size=512,
        mla=MLADims(d_model=256, n_heads=8, q_lora_rank=128,
                    kv_lora_rank=64))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda x: x.to(cuda_device), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 200)))
    smoke = chip_smoke()
    counters = smoke.kernel_modules()
    smoke.zero_counts()
    with torch.no_grad():
        got, _ = model.apply(on_card, {"tokens": toks.to(cuda_device)})
        want, _ = model.apply(params, {"tokens": toks})
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * scale
    caches = [model.init_cache(2, max_seq=6, device=d, dtype=torch.float32)
              for d in (cuda_device, "cpu")]
    for i in range(8):
        step_g, caches[0] = model.decode_step(
            on_card, caches[0], toks[:, i:i + 1].to(cuda_device))
        step_w, caches[1] = model.decode_step(params, caches[1],
                                              toks[:, i:i + 1])
        assert (step_g.cpu() - step_w).abs().max().item() <= 1e-4 * scale
    for a, b in zip(leaves(caches[0]), leaves(caches[1])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    assert caches[0][0]["b0"]["pos"].tolist() == [[8, 8], [8, 8]]
    torch.cuda.synchronize()
    assert smoke.read_counts() == dict.fromkeys(counters, 0)


@pytest.mark.requires_cuda
def test_trainer_on_card_with_checkpoint_round_trip(cuda_device, tmp_path):
    """Two steps of the Trainer on the card through the kernels, a
    checkpoint at each, and the last restored bit for bit."""
    import repro_torch.core as rc
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, init_train_state
    from repro_torch.tree import leaves

    rc.plan("threads", workers=2)
    cfg = get_arch("xlstm-125m", smoke=True)
    tcfg = TrainerConfig(steps=2, batch=2, seq=512, log_every=1,
                         ckpt_every=1, ckpt_dir=str(tmp_path))
    trainer = Trainer(cfg, tcfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=2))
    MK.launches = SK.launches = 0
    state, history = trainer.run()
    rc.shutdown()
    assert (MK.launches, SK.launches) == (4, 2)
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002"]
    template = init_train_state(Model(cfg).init(
        torch.Generator(device=cuda_device), device=cuda_device))
    restored, step = trainer.ckpt.restore(template, 2)
    assert step == 2
    for a, b in zip(leaves(restored), leaves(state)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# plan("cuda_async") on the card: futures resolved by CUDA events
# --------------------------------------------------------------------------

#: cycles of torch.cuda._sleep for ~50 ms at the H100's ~1.98 GHz
_SLEEP_50MS = 100_000_000


@pytest.mark.requires_cuda
def test_cuda_async_resolves_with_the_stream_on_card(cuda_device):
    """The body only enqueues: right after submit the future is not
    resolved (its ~50 ms of device work is queued), and value() waits for
    the event."""
    import repro_torch.core as rc
    rc.plan("cuda_async")
    x = torch.ones(4, device=cuda_device)
    x * 2                   # load the kernel first: a lazy module load syncs
    torch.cuda.synchronize()
    f = rc.future(lambda: torch.cuda._sleep(_SLEEP_50MS) or x * 2)
    assert rc.resolved(f) is False
    torch.testing.assert_close(rc.value(f), torch.full_like(x, 2.0))
    assert rc.resolved(f) is True


@pytest.mark.requires_cuda
def test_cuda_async_callback_exactly_once_under_races_on_card(cuda_device):
    """S4 with real events: four threads register callbacks while the
    device work completes; each fires exactly once in all 30 rounds."""
    import threading
    import time

    import repro_torch.core as rc
    rc.plan("cuda_async")
    be = rc.active_backend()
    for r in range(30):
        cycles = (0, 20_000, 2_000_000)[r % 3]
        f = rc.future(lambda c=cycles: torch.cuda._sleep(c) or
                      torch.arange(16, device=cuda_device).sum())
        fired = []
        lock = threading.Lock()

        def register(k, _f=f, _fired=fired, _lock=lock):
            def cb(_h, _k=k):
                with _lock:
                    _fired.append(_k)
            be.add_done_callback(_f._handle, cb)

        ts = [threading.Thread(target=register, args=(k,)) for k in range(4)]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with lock:
                if len(fired) >= 4:
                    break
            time.sleep(0.001)
        time.sleep(0.002)
        with lock:
            assert sorted(fired) == [0, 1, 2, 3], r
        assert int(rc.value(f)) == 120


@pytest.mark.requires_cuda
def test_cuda_async_watcher_leaves_the_gil_free_on_card(cuda_device):
    """While a watcher thread waits on ~300 ms of device work, the main
    thread keeps running Python: no gap between its loop iterations comes
    near the wait (the watcher's synchronize() releases the GIL)."""
    import threading
    import time

    import repro_torch.core as rc
    rc.plan("cuda_async")
    f = rc.future(lambda: torch.cuda._sleep(6 * _SLEEP_50MS))
    fired = threading.Event()
    rc.active_backend().add_done_callback(f._handle,
                                          lambda h: fired.set())
    gaps, last, n = [], time.perf_counter(), 0
    while not fired.is_set():
        now = time.perf_counter()
        gaps.append(now - last)
        last, n = now, n + 1
    assert rc.resolved(f) and n > 1000
    assert max(gaps) < 0.05, max(gaps)


@pytest.mark.requires_cuda
def test_future_map_prefill_cuda_async_equals_sequential_on_card(
        cuda_device):
    """future_map of the smoke xLSTM prefill over 4 batches of S=512
    (where the chunkwise mLSTM, the kernel's form, begins): cuda_async's
    tokens are sequential's bit for bit (the same kernels on the same
    inputs on one stream), with one kernel launch a block a batch."""
    import repro_torch.core as rc
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step

    cfg = get_arch("xlstm-125m", smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        device=cuda_device)
    prefill = make_prefill_step(model)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(2, 512))).to(cuda_device)}
        for _ in range(4)]
    runs = {}
    for name in ("sequential", "cuda_async"):
        rc.plan(name)
        MK.launches = SK.launches = 0
        runs[name] = rc.future_map(lambda b: prefill(params, b), batches)
        torch.cuda.synchronize()
        runs[name + " launches"] = (MK.launches, SK.launches)
        rc.shutdown()
    n_m = sum(k == "mlstm" for k in cfg.layer_pattern)
    n_s = sum(k == "slstm" for k in cfg.layer_pattern)
    for name in ("sequential", "cuda_async"):
        assert runs[name + " launches"] == (4 * n_m, 4 * n_s)
    for a, b in zip(runs["sequential"], runs["cuda_async"]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# plan("processes") on the card: CUDA tensors cross the pipe as bytes
# --------------------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_processes_ship_cuda_tensors_bit_for_bit_on_card(cuda_device, dtype):
    """A CUDA tensor global (one content-addressed, one inline) reaches a
    worker on its card and comes back on the card, bit for bit."""
    import repro_torch.core as rc
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    big = torch.randn(256, 384, generator=gen, device=cuda_device) \
        .to(dtype)
    small = torch.randn(8, generator=gen, device=cuda_device).to(dtype)
    rc.plan("processes", workers=1)
    try:
        got_big, got_small, where = rc.value(rc.future(
            lambda: (big, small, (big.device.type, small.device.type,
                                  str(big.dtype)))), timeout=300)
    finally:
        rc.shutdown()
    assert where == ("cuda", "cuda", str(dtype))
    for got, want in ((got_big, big), (got_small, small)):
        assert got.is_cuda and got.dtype == dtype
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))


@pytest.mark.requires_cuda
def test_processes_see_an_in_place_write_to_a_cuda_global_on_card(
        cuda_device):
    """A CUDA global written in place between two futures reaches the
    worker with its new bytes (the digest memo follows the version)."""
    import repro_torch.core as rc
    w = torch.zeros(10_000, device=cuda_device)
    rc.plan("processes", workers=1)
    try:
        assert rc.value(rc.future(lambda: float(w.sum())), timeout=300) \
            == 0.0
        w.add_(1.0)
        assert rc.value(rc.future(lambda: float(w.sum())), timeout=300) \
            == 10_000.0
    finally:
        rc.shutdown()


@pytest.mark.requires_cuda
def test_processes_worker_without_cuda_refuses_a_cuda_payload_on_card(
        cuda_device, monkeypatch):
    """No fallback: a worker started with ``CUDA_VISIBLE_DEVICES=""`` is
    sent a CUDA tensor and raises; it does not rebuild it on the CPU."""
    import repro_torch.core as rc
    g = torch.arange(10_000, dtype=torch.float32, device=cuda_device)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    rc.plan("processes", workers=1)
    try:
        rc.active_backend()                  # the worker starts without one
        monkeypatch.undo()
        assert rc.value(rc.future(lambda: torch.cuda.is_available()),
                        timeout=300) is False
        with pytest.raises(rc.ChannelError, match="no CUDA device"):
            rc.value(rc.future(lambda: float(g.sum())), timeout=300)
        with pytest.raises(rc.ChannelError, match="no CUDA device"):
            rc.value(rc.future(lambda: float(g[:4].sum())), timeout=300)
    finally:
        rc.shutdown()


# --------------------------------------------------------------------------
# plan("cluster") on the card: a held CUDA result stays on its worker
# --------------------------------------------------------------------------

@pytest.mark.requires_cuda
def test_cluster_holds_a_cuda_result_chains_on_holder_and_pulls_bits(
        cuda_device):
    """A CUDA tensor a cluster task returns stays on its worker (a
    RemoteValue at the driver), a continuation runs on the holder's card
    with under a tenth of the tensor through the driver, and value()
    pulls it onto this card bit for bit."""
    import os

    import repro_torch.core as rc
    from repro_torch.core.backends import transport
    from repro_torch.core.backends.blobstore import RemoteValue

    def make():
        g = torch.Generator(device="cuda").manual_seed(7)
        return torch.randn(1024, 1024, generator=g, device="cuda")

    want = make()
    rc.plan("cluster", workers=2, token=os.urandom(8).hex())
    try:
        backend = rc.active_backend()
        f = rc.future(make)
        run = backend.collect(f._handle)
        assert isinstance(run.value, RemoteValue)
        holders = backend.locations(run.value.digest)
        assert len(holders) == 1
        transport.reset_wire_stats()
        pid, dev, total = f.then(lambda t: (
            os.getpid(), t.device.type, t.double().sum().item())) \
            .value(timeout=300)
        assert transport.wire_stats()["bytes_recv"] < want.nbytes // 10
        assert pid != os.getpid() and dev == "cuda"
        assert total == want.double().sum().item()
        got = f.value(timeout=300)
        assert got.is_cuda and torch.equal(got.view(torch.int32),
                                           want.view(torch.int32))
    finally:
        rc.shutdown()


@pytest.mark.requires_cuda
def test_cluster_peer_fetches_a_cuda_result_between_workers(
        cuda_device, tmp_path):
    """While the holder of a CUDA result is busy, a future on the other
    worker that takes the RemoteValue as an argument gets its bytes by
    peer fetch (not through the driver) and rebuilds it on its own card."""
    import os
    import time

    import repro_torch.core as rc
    from repro_torch.core.backends import transport

    pidfile, release = str(tmp_path / "pid"), str(tmp_path / "go")

    def park(t, _p=pidfile, _r=release):
        import os as _os
        import time as _time
        with open(_p, "w") as fh:
            fh.write(str(_os.getpid()))
        while not _os.path.exists(_r):
            _time.sleep(0.005)
        return 0

    rc.plan("cluster", workers=2)
    try:
        backend = rc.active_backend()
        f = rc.future(lambda: torch.arange(1 << 20, dtype=torch.float32,
                                           device="cuda"))
        rv = backend.collect(f._handle).value
        holder_wids = backend.locations(rv.digest)
        with backend._pool_cv:
            holder_pids = {w.meta["pid"] for w in backend._all
                           if w.wid in holder_wids}
        blocker = f.then(park)
        deadline = time.monotonic() + 120
        while not os.path.exists(pidfile):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        transport.reset_wire_stats()
        pid, dev, total = rc.value(rc.future(
            lambda t: (os.getpid(), t.device.type, float(t.sum())), rv),
            timeout=300)
        sent = transport.wire_stats()["bytes_sent"]
        open(release, "w").close()
        assert pid not in holder_pids and dev == "cuda"
        assert total == float(torch.arange(1 << 20, dtype=torch.float32)
                              .sum())
        assert sent < rv.nbytes // 10
        assert rc.value(blocker, timeout=300) == 0
    finally:
        rc.shutdown()


# --------------------------------------------------------------------------
# the build, on any host
# --------------------------------------------------------------------------

def test_build_targets_are_hashed_per_source():
    from repro_torch.kernels import _build
    assert _build.sources() == ["decode_attention", "flash_attention",
                                "mlstm_scan", "rglru_scan", "slstm_scan"]
    for name in _build.sources():
        target = _build._target(name)
        assert target.parent == _build.BUILD_DIR
        assert target.name.startswith(f"{name}-") and target.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_targets_keep_instrumented_builds_apart():
    """A build with extra defines lands in a file of its own."""
    from repro_torch.kernels import _build
    plain = _build._target("mlstm_scan")
    clocked = _build._target("mlstm_scan", ("MLSTM_PHASE_CLOCKS",))
    assert clocked != plain and clocked.parent == plain.parent
    assert clocked.name.startswith("mlstm_scan-")
    assert _build._flags(("X",))[-1] == "-DX"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("mlstm_scan")
