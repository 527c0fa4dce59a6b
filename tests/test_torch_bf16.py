"""The port from bf16 parameters (yi-9b and yi-34b at smoke size) against
``repro.models.Model`` initialised in bf16 and converted by
``params_from_jax``: the logits, 8 decode steps on bf16 and on fp32
caches, both step builders and the Server, all within the bf16 tolerance
(2e-2 of the largest logit, ``_tol``'s bf16 value); the attention kernels'
plain versions with a bf16 q on an fp32 cache and an fp32 q on a bf16
cache against the Pallas decode kernel; the plain flash version's query-row
blocks and its fp64 sums; the bf16 launch geometry of both kernels; and
chip_smoke.py's 1-ulp yardstick and widened-kernel wrapper."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import (ATTN_TOL, _reset_port,  # noqa: E402,F401
                           chip_smoke, decided, decode_inputs, flash_inputs,
                           jax_greedy, jax_serve_example, n, serve_all, t)

import repro.core as jrc  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as jax_decode_attention  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro.train import make_serve_step as jax_serve  # noqa: E402
import repro_torch.core as rc  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import decode_attention as DK  # noqa: E402
from repro_torch.kernels import flash_attention as FK  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import Server  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCHS = ["yi-9b", "yi-34b"]
B = 2
#: the bf16 tolerance, relative to the largest logit
TOL = 2e-2

_SMOKE: dict = {}


def _smoke_bf16(arch):
    """(jax cfg, torch cfg, jax bf16 params, the port's bf16 params), built
    once per arch."""
    if arch not in _SMOKE:
        jcfg, tcfg = jax_arch(arch, smoke=True), get_arch(arch, smoke=True)
        jp = JModel(jcfg).init(jax.random.PRNGKey(0), jnp.bfloat16)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
        assert {x.dtype for x in jax.tree_util.tree_leaves(tp)} == \
            {torch.bfloat16}
        _SMOKE[arch] = (jcfg, tcfg, jp, tp)
    return _SMOKE[arch]


def _tokens(seed, s, vocab, b=B):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


def _assert_close(got, want, tol=TOL):
    """Every logit within ``tol`` of the largest of ``want``."""
    got, want = n(got).astype(np.float32), n(want).astype(np.float32)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("s", [32, 160])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_from_bf16_params_match_reference(arch, s):
    jcfg, tcfg, jp, tp = _smoke_bf16(arch)
    toks = _tokens(s, s, jcfg.vocab_size)
    want, _ = jax.jit(JModel(jcfg).apply)(jp, {"tokens": jnp.asarray(toks)})
    got, _ = Model(tcfg).apply(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, s,
                                                        jcfg.vocab_size)
    _assert_close(got, want)


@pytest.mark.parametrize("cache", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_8_steps_from_bf16_params_match_reference(arch, cache):
    """A bf16 q on a bf16 cache and on an fp32 one, as the Server's fp32
    caches meet a bf16 model: every step's logits, and the last step
    against the port's own prefill."""
    jcfg, tcfg, jp, tp = _smoke_bf16(arch)
    jm, tm = JModel(jcfg), Model(tcfg)
    jcache = jm.init_cache(B, max_seq=16, dtype=getattr(jnp, cache))
    tcache = tm.init_cache(B, max_seq=16, device="cpu",
                           dtype=getattr(torch, cache))
    step = jax.jit(jm.decode_step)
    toks = _tokens(1, 8, jcfg.vocab_size)
    for i in range(8):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]))
        _assert_close(tl, jl)
    assert tcache[0]["b0"]["k"].dtype == getattr(torch, cache)
    full, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    _assert_close(tl[:, 0], full[:, -1])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_tokens_from_bf16_params_match_reference(arch):
    jcfg, tcfg, jp, tp = _smoke_bf16(arch)
    toks = _tokens(4, 48, jcfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks)}
    want = jax.jit(jax_prefill(JModel(jcfg)))(jp, batch)
    logits, _ = jax.jit(JModel(jcfg).apply)(jp, batch)
    got = make_prefill_step(Model(tcfg))(tp, {"tokens":
                                             torch.from_numpy(toks)})
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    sure = decided(logits[:, -1], TOL)
    assert sure.any()
    np.testing.assert_array_equal(n(got)[sure, 0], n(want)[sure, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_tokens_from_bf16_params_match_reference(arch):
    """16 greedy steps on fp32 caches, both packages fed the reference's
    tokens; each step's tokens agree where the reference's top-2 margin
    exceeds the tolerance."""
    jcfg, tcfg, jp, tp = _smoke_bf16(arch)
    jm, tm = JModel(jcfg), Model(tcfg)
    jstep, tstep = jax.jit(jax_serve(jm)), make_serve_step(tm)
    jdecode = jax.jit(jm.decode_step)
    jcache, lcache = (jm.init_cache(B, max_seq=32, dtype=jnp.float32)
                      for _ in range(2))
    tcache = tm.init_cache(B, max_seq=32, device="cpu", dtype=torch.float32)
    jt = jnp.asarray(_tokens(5, 1, jcfg.vocab_size), jnp.int32)
    decided_any = False
    for _ in range(16):
        tt, tcache = tstep(tp, tcache, torch.from_numpy(np.array(jt)))
        logits, lcache = jdecode(jp, lcache, jt)
        jt, jcache = jstep(jp, jcache, jt)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
        sure = decided(logits[:, -1], TOL)
        decided_any |= bool(sure.any())
        np.testing.assert_array_equal(n(tt)[sure, 0], n(jt)[sure, 0])
    assert decided_any


@pytest.mark.parametrize("arch", ARCHS)
def test_server_from_bf16_params_matches_jax_server_tokens(arch):
    """The smoke Server on the CPU with ``params=`` the converted bf16 tree
    answers 6 requests (4 then 2 in a batch) with the JAX Server's greedy
    tokens on the same bf16 tree, up to each request's first token whose
    top-2 margin in the reference is within the tolerance: there greedy
    decoding of a bf16 model may go either way, and every later token
    follows that choice. At least 16 of the 96 tokens are held so."""
    mod = jax_serve_example()
    jcfg, tcfg, jp, tp = _smoke_bf16(arch)
    jrc.plan("threads", workers=8)
    jserver = mod.Server(arch=arch)
    jserver.params = jp
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=4).tolist()
               for _ in range(6)]
    want = serve_all(jserver, jrc, prompts)
    jrc.shutdown()

    rc.plan("threads", workers=8)
    server = Server(arch, device="cpu", params=tp)
    got = serve_all(server, rc, prompts)
    assert all(len(toks) == 16 for toks in got)
    # the JAX Server's two batches: the first 4 requests, then 2
    first, second = (jax_greedy(jcfg, jp, batch, TOL)
                     for batch in (prompts[:4], prompts[4:]))
    ref_toks, sure = first[0] + second[0], first[1] + second[1]
    held = 0
    for g_, w_, r_, d_ in zip(got, want, ref_toks, sure):
        k = d_.index(False) if False in d_ else len(d_)
        assert g_[:k] == w_[:k] == r_[:k]
        held += k
    assert held >= 16, held          # 32 (yi-9b) and 24 (yi-34b) of 96


# --------------------------------------------------------------------------
# the kernels' plain versions and geometry in bf16
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q_dtype,cache_dtype", [("bfloat16", "float32"),
                                                 ("float32", "bfloat16")])
@pytest.mark.parametrize("b,kv,g,s,d", [(2, 8, 7, 160, 128),
                                        (2, 4, 8, 300, 64),
                                        (3, 1, 16, 128, 256)])
def test_decode_mixed_types_match_jax_kernel(b, kv, g, s, d, q_dtype,
                                             cache_dtype):
    """``ops.decode_attention`` on the CPU with q and the cache of
    different types (the Server's fp32 caches meet a bf16 model's q) against
    the Pallas kernel in interpret mode on the same values; the output
    takes q's type."""
    q, k, v, lengths = decode_inputs(b + s + d, b, kv, g, s, d)
    qt, ct = getattr(torch, q_dtype), getattr(torch, cache_dtype)
    qj, cj = getattr(jnp, q_dtype), getattr(jnp, cache_dtype)
    got = ops.decode_attention(t(q).to(qt), t(k).to(ct), t(v).to(ct),
                               t(lengths))
    want = jax_decode_attention(jnp.asarray(q, qj), jnp.asarray(k, cj),
                                jnp.asarray(v, cj), jnp.asarray(lengths),
                                bs=128, interpret=True)
    assert got.dtype == qt
    np.testing.assert_allclose(n(got.float()), n(want.astype(jnp.float32)),
                               **ATTN_TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("b,kv,g,s,d,causal,window,block", [
    (2, 2, 3, 150, 16, True, None, 64),     # three blocks, a ragged last
    (1, 1, 4, 300, 64, True, 50, 100),      # a window across block edges
    (2, 2, 2, 130, 32, False, None, 128),   # a block of 2 rows at the end
    (1, 8, 7, 513, 128, True, None, ref.FLASH_ROW_BLOCK)])
def test_plain_flash_row_blocks_are_the_unblocked_function(
        monkeypatch, b, kv, g, s, d, causal, window, block, dtype):
    """The plain flash version walks the query rows in blocks: bit for bit
    its result with every row at once, for blocks that cut a causal
    diagonal, a window and a ragged tail (a score budget of one byte cuts
    them to ``block`` rows)."""
    q, k, v = (t(a).to(getattr(torch, dtype))
               for a in flash_inputs(s + d, b, kv, g, s, d))
    assert ref.flash_row_block(b, kv * g, s, s) == s
    whole = ref.flash_attention(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(ref, "FLASH_SCORE_BYTES", 1)
    monkeypatch.setattr(ref, "FLASH_ROW_BLOCK", block)
    assert ref.flash_row_block(b, kv * g, s, s) == block
    blocked = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert blocked.dtype == q.dtype
    assert torch.equal(blocked, whole)
    assert FK.plain is ref.flash_attention


@pytest.mark.parametrize("b,h,s,rows", [
    (1, 16, 4096, 4096),    # RecurrentGemma, qwen2-moe, deepseek-moe: 1 GiB
    (1, 32, 4096, 2048),    # Yi-9B
    (1, 56, 4096, 1024),    # Yi-34B
    (4, 56, 4096, 512),     # at least one multiple of 512
    (2, 8, 300, 300)])      # the smoke shapes: every row at once
def test_plain_flash_row_block_bounds_the_scores(b, h, s, rows):
    """The plain version's query-row blocks keep its fp32 scores within
    1 GiB: every row at once where they fit (so RecurrentGemma's, Yi-9B's
    and the MoE prefills' plain paths sum as before), else the largest
    multiple of 512 rows (Yi-34B's 56 x 4096^2 scores would take 3.76 GB,
    about three of them alive)."""
    assert ref.flash_row_block(b, h, s, s) == rows
    if rows < s:
        assert 4 * b * h * rows * s <= ref.FLASH_SCORE_BYTES or rows == 512
        assert 4 * b * h * (rows + 512) * s > ref.FLASH_SCORE_BYTES


@pytest.mark.parametrize("b,kv,g,s,d,causal,window", [
    (2, 2, 3, 150, 16, True, None),
    (1, 1, 4, 300, 64, True, 50),
    (2, 2, 2, 130, 32, False, None)])
def test_plain_flash_sums_fp64_inputs_in_fp64(b, kv, g, s, d, causal,
                                              window):
    """fp64 inputs keep the plain flash version in fp64 (the reference of
    chip_smoke.py's RecurrentGemma prefill check): the fp32 function within
    fp32's tolerance, with row blocks sized by 8-byte scores (RG's in
    2048-row blocks, where its fp32 scores take one)."""
    q, k, v = (t(a) for a in flash_inputs(s + d, b, kv, g, s, d))
    f32 = ref.flash_attention(q, k, v, causal=causal, window=window)
    f64 = ref.flash_attention(q.double(), k.double(), v.double(),
                              causal=causal, window=window)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(n(f64), n(f32), **ATTN_TOL["float32"])
    assert ref.flash_row_block(1, 16, 4096, 4096, 8) == 2048
    assert ref.flash_row_block(1, 16, 4096, 4096) == 4096


def test_widened_flash_in_fp64_is_the_plain_path_summed_wider():
    """chip_smoke.WidenedFlash(torch.float64) hands the plain path's flash
    calls fp64 q, k and v and rounds their output back: the yi-9b smoke
    prefill from fp32 parameters stays fp32 and within 1e-5 of its largest
    logit of the unwidened plain path."""
    cs = chip_smoke()
    _, tcfg, _, tp = _smoke_bf16("yi-9b")
    params = tree_map(lambda x: x.float(), tp)
    model = Model(tcfg, kernel_impl="plain")
    toks = {"tokens": torch.from_numpy(_tokens(3, 40, tcfg.vocab_size))}
    want, _ = model.apply(params, toks)
    flash, seen = ops.flash_attention, []
    ops.flash_attention = lambda q, k, v, **kw: (
        seen.append(q.dtype) or flash(q, k, v, **kw))
    try:
        with cs.WidenedFlash(torch.float64):
            got, _ = model.apply(params, toks)
    finally:
        ops.flash_attention = flash
    assert seen == [torch.float64] * tcfg.n_layers
    assert got.dtype == torch.float32
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("d", FK.HEAD_DIMS)
def test_flash_bf16_tiles_fit_shared_memory(d):
    """bf16 tiles: the Q tile, one K and one V block, all at row pitch
    d + 8 (d / 2 + 4 words, an odd multiple of 4: 4 mod 32 at d = 64, 128,
    256, 12 at 80, so ldmatrix's 8 rows of 16 bytes fall on 8 distinct
    4-bank groups and meet no bank twice), two bytes an element."""
    geo = FK.geometry(1, 56, 8, 4096, 4096, d, True, None,
                      dtype=torch.bfloat16)
    assert geo.el == 2
    assert FK.pitches(d, 2) == (d + 8, d + 8)
    assert geo.smem_bytes == FK.smem_bytes(d, 2) == \
        2 * (160 * (d + 8) + 32 * (d + 8))
    words = (d + 8) * 2 // 4
    assert len({row * words % 32 // 4 for row in range(8)}) == 8
    assert geo.smem_bytes < FK.smem_bytes(d) <= FK.SMEM_LIMIT


def test_flash_geometry_at_the_yi_34b_shape_in_bf16():
    """Yi-34B's prefill (56 heads over 8 KV heads of 128, S=4096, causal):
    the fp32 launch with less than half the shared memory (pitch d + 8, not
    d + 16) and half the K and V bytes from L2."""
    geo = FK.geometry(1, 56, 8, 4096, 4096, 128, True, None,
                      dtype=torch.bfloat16)
    fp32 = FK.geometry(1, 56, 8, 4096, 4096, 128, True, None)
    assert (geo.tiles, geo.ctas, geo.smem_bytes) == (32, 1792, 52224)
    assert geo.plan == (1792, 256, 52224)
    # the bf16 launch bounds ask registers for 2 CTAs a SM up to D=128
    assert (geo.ctas_per_sm, geo.waves, fp32.ctas_per_sm) == (2, 7, 1)
    assert FK.geometry(1, 16, 1, 4096, 4096, 256, dtype=torch.bfloat16
                       ).ctas_per_sm == 1
    assert geo.order == fp32.order and geo.key_rows == fp32.key_rows
    assert geo.l2_bytes * 2 == fp32.l2_bytes
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FK.geometry(1, 56, 8, 64, 64, 128, dtype=torch.float16)


@pytest.mark.parametrize("dtype,row_stride,ok", [
    (torch.bfloat16, 2 ** 24 - 8, True),
    (torch.bfloat16, 2 ** 24, False),
    (torch.bfloat16, 2 ** 31, False),
    (torch.float32, 2 ** 33, True)])
def test_flash_row_stride_bound(dtype, row_stride, ok):
    """The bf16 kernel takes row strides below 2^24 elements, so that its
    copies' 32-bit offsets (row x stride, row < 128) stay below 2^31; the
    fp32 kernel any. Checked on views with no storage (meta)."""
    assert FK.BF16_STRIDE_LIMIT * FK.ROWS == 2 ** 31
    x = torch.empty_strided((1, 1, 4, 128), (4 * row_stride, 4 * row_stride,
                                             row_stride, 1),
                            dtype=dtype, device="meta")
    el = x.element_size()
    if ok:
        FK._check_rows("q", x, el)
    else:
        with pytest.raises(ValueError, match="below 2\\^24"):
            FK._check_rows("q", x, el)


def test_decode_geometry_with_a_bf16_q():
    """A bf16 q changes only the bytes of q and the output: the launch is
    the fp32 q's (q is held in fp32 in shared memory)."""
    lengths = (1, 1000, 4096, 4096)
    geo = DK.launch_geometry(4, 56, 8, 4096, 128, torch.bfloat16, lengths,
                             q_dtype=torch.bfloat16)
    fp32_q = DK.launch_geometry(4, 56, 8, 4096, 128, torch.bfloat16,
                                lengths)
    assert geo.plan == fp32_q.plan and geo.q_el == 2
    rows = 8 * sum(lengths)
    assert geo.hbm_bytes == 2 * rows * 128 * 2 + 4 * 4 * 56 * 128 + 16
    assert fp32_q.hbm_bytes - geo.hbm_bytes == 4 * 4 * 56 * 128
    with pytest.raises(ValueError, match="q must be"):
        DK.launch_geometry(1, 8, 1, 64, 64, q_dtype=torch.float16)


def test_cpu_wrappers_take_bf16_and_return_its_type():
    """On CPU tensors the dispatch runs the plain versions in bf16 and
    counts no launch."""
    fl, dl = FK.launches, DK.launches
    q, k, v = (t(a).to(torch.bfloat16)
               for a in flash_inputs(0, 1, 2, 7, 40, 64))
    assert ops.flash_attention(q, k, v).dtype == torch.bfloat16
    qd, kd, vd, ln = decode_inputs(0, 2, 2, 7, 40, 64)
    out = ops.decode_attention(t(qd).to(torch.bfloat16), t(kd), t(vd),
                               t(ln))
    assert out.dtype == torch.bfloat16
    assert (FK.launches, DK.launches) == (fl, dl)


# --------------------------------------------------------------------------
# chip_smoke.py's yardstick and widened-kernel wrapper, on the CPU
# --------------------------------------------------------------------------

def test_one_ulp_moved_steps_a_bf16_table_by_one_ulp():
    """A bf16 table moves to each element's next value away from zero (a
    scale by 1 + 2^-23 would round back to the same table); an fp32 table
    is scaled by 1 + 2^-23, as the fp32 phases have always moved it."""
    cs = chip_smoke()
    table = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 32)).astype(np.float32))
    table[0, :3] = torch.tensor([0.0, -0.0, 1.0])
    bf = table.to(torch.bfloat16)
    moved = cs.one_ulp_moved({"embed": {"table": bf}, "x": 1})
    assert moved["x"] == 1
    got = moved["embed"]["table"]
    assert got.dtype == torch.bfloat16 and not torch.equal(got, bf)
    steps = got.view(torch.int16).int() - bf.view(torch.int16).int()
    assert torch.all(steps == 1)
    assert torch.all(got.float().abs() > bf.float().abs())
    assert torch.equal(bf * (1 + 2 ** -23), bf)      # why it cannot scale
    f32 = cs.one_ulp_moved({"embed": {"table": table}})["embed"]["table"]
    assert torch.equal(f32, table * (1 + 2 ** -23))


def test_widened_flash_is_the_bf16_prefill_bit_for_bit_on_cpu():
    """chip_smoke.WidenedFlash widens each flash_attention call's q, k and
    v to fp32 and rounds its output back, and restores the entry after:
    on the CPU (the plain version, which widens the same way) the yi-34b
    smoke prefill from bf16 parameters is unchanged bit for bit, and a
    stand-in that sees the calls gets bf16 in and fp32 in."""
    cs = chip_smoke()
    _, tcfg, _, tp = _smoke_bf16("yi-34b")
    model = Model(tcfg)
    toks = {"tokens": torch.from_numpy(_tokens(2, 40, tcfg.vocab_size))}
    flash = ops.flash_attention
    want, _ = model.apply(tp, toks)
    with cs.WidenedFlash():
        assert ops.flash_attention is not flash
        got, _ = model.apply(tp, toks)
    assert ops.flash_attention is flash
    assert torch.equal(got, want)
    seen = []
    ops.flash_attention = lambda q, k, v, **kw: (
        seen.append(q.dtype) or flash(q, k, v, **kw))
    try:
        with cs.WidenedFlash():
            model.apply(tp, toks)
        model.apply(tp, toks)
    finally:
        ops.flash_attention = flash
    assert seen == [torch.float32] * tcfg.n_layers \
        + [torch.bfloat16] * tcfg.n_layers
