"""The port's audio family (hubert-xlarge) against the JAX package on the
CPU, and the flash kernel's plain versions at HuBERT's head dim of 80.

Modules: the gelu MLP (the tanh GELU, pinned against the exact one), the
conv positional encoding in fp32 and bf16 (its (64, 63) padding pinned
against PyTorch's ``padding="same"``) and the audio frontend. Models: the
smoke config and a narrow one at HuBERT's head dim (3 layers, 2 heads of
80): logits, loss and every grad leaf within ``MODEL_TOL``, logits from a
bf16 tree, both step builders, the trees bit for bit and the full tree on
``meta``; decode refused as the reference's launcher refuses it. Flash attention at D=80, non-causal,
G=1, S=200: the plain version and both instances' arithmetic
(3xTF32, bf16 with P in two parts) against the Pallas kernel in interpret
mode and its jnp oracle; the launch geometry and shared memory at D=80 in
both types, and ``chip_smoke.py``'s 1-ulp yardstick on an audio tree."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from _torch_parity import (ATTN_TOL, MODEL_TOL, _reset_port,  # noqa: E402,F401
                           chip_smoke, flash_inputs, n, randn, t)

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro.launch.specs import build_dryrun  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import make_eval_step as jax_eval  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import _to_tensor, params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as FK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import Server  # noqa: E402
from repro_torch.train import make_eval_step, make_prefill_step  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

ARCH = "hubert-xlarge"
B = 2
#: JAX's Model.param_count of the full config (fp32 leaves)
FULL_PARAMS = 959_020_800


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def test_configs_match_reference():
    for smoke in (False, True):
        j, t_ = jax_arch(ARCH, smoke=smoke), get_arch(ARCH, smoke=smoke)
        assert dataclasses.asdict(t_) == dataclasses.asdict(j)
        assert t_.stages == j.stages


def test_gelu_mlp_matches_reference_and_is_the_tanh_gelu():
    """``mlp_apply(..., "gelu")`` against the reference's, and the GELU is
    ``jax.nn.gelu``'s default, the tanh approximation: the exact (erf)
    GELU is off the reference by more than the model tolerance."""
    key = jax.random.PRNGKey(3)
    jp = JL.mlp_init(key, 64, 128, "gelu")
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = randn(np.random.default_rng(3), B, 24, 64, scale=2.0)
    want = JL.mlp_apply(jp, jnp.asarray(x), "gelu")
    np.testing.assert_allclose(n(TL.mlp_apply(tp, t(x), "gelu")), n(want),
                               **MODEL_TOL)
    z = np.linspace(-4, 4, 2001, dtype=np.float32)
    np.testing.assert_allclose(n(TL.gelu(t(z))), n(jax.nn.gelu(z)),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(n(F.gelu(t(z))) - n(jax.nn.gelu(z))).max() > 1e-4


CONV_CASES = [  # d, kernel, groups, s
    (64, 128, 16, 40),     # the smoke width, HuBERT's kernel and groups
    (32, 128, 16, 300),    # a narrow d, S past the kernel
    (12, 5, 4, 9),         # an odd kernel: pads (2, 2)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,kernel,groups,s", CONV_CASES)
def test_convpos_matches_reference(d, kernel, groups, s, dtype):
    """fp32 within ``MODEL_TOL``; bf16 (the conv summed in fp32, as XLA
    sums it) within 2e-2 of the largest value."""
    jdt = getattr(jnp, dtype)
    jp = JL.convpos_init(jax.random.PRNGKey(d), d, kernel, groups, jdt)
    jp = dict(jp, b=jax.random.normal(jax.random.PRNGKey(1), (d,), jdt))
    tp = {k: _to_tensor(np.array(v)) for k, v in jp.items()}
    assert tuple(tp["w"].shape) == (kernel, d // groups, d)
    x = randn(np.random.default_rng(s), B, s, d)
    want = JL.convpos_apply(jp, jnp.asarray(x, jdt), groups)
    got = TL.convpos_apply(tp, t(x).to(getattr(torch, dtype)), groups)
    assert got.shape == (B, s, d) and got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(n(got), want, **MODEL_TOL)
    else:
        np.testing.assert_allclose(n(got.float()), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


def test_convpos_pads_64_then_63_frames():
    """At kernel 128 the reference pads 64 frames before and 63 after;
    PyTorch's ``padding="same"`` pads 63 before and 64 after, which shifts
    the output one frame early and misses the reference."""
    d, groups = 32, 16
    jp = JL.convpos_init(jax.random.PRNGKey(0), d)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = randn(np.random.default_rng(0), 1, 200, d)
    want = n(JL.convpos_apply(jp, jnp.asarray(x), groups))
    same = F.conv1d(t(x).transpose(1, 2), tp["w"].permute(2, 1, 0),
                    padding="same", groups=groups).transpose(1, 2)
    same = n(TL.gelu(same + tp["b"]))
    assert np.abs(same - want).max() > 1e-2
    # padding="same" gives at frame i the reference's frame i + 1
    np.testing.assert_allclose(same[:, :-1], want[:, 1:], **MODEL_TOL)


def test_init_makes_the_reference_leaves():
    """The port's tree for hubert has JAX's leaves (the unused embedding
    table, the frontend's proj and convpos, final_norm, unembed, the
    stages), path for path and shape for shape."""
    for smoke in (True, False):
        j = jax.eval_shape(JModel(jax_arch(ARCH, smoke=smoke)).init,
                           jax.random.PRNGKey(0))
        tp = Model(get_arch(ARCH, smoke=smoke)).init(torch.Generator(),
                                                     device="meta")
        want = jax.tree_util.tree_leaves_with_path(j)
        got = jax.tree_util.tree_leaves_with_path(tp)
        assert [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in got] \
            == [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in want]


# --------------------------------------------------------------------------
# models: the smoke config and a narrow one at HuBERT's head dim
# --------------------------------------------------------------------------

def _cfgs(name: str):
    """(jax cfg, torch cfg): the smoke config (2 layers, 4 heads of 16) or
    3 layers at HuBERT's head dim (d_model 160, 2 heads of 80, d_ff 320)."""
    j, t_ = jax_arch(ARCH, smoke=True), get_arch(ARCH, smoke=True)
    if name == "smoke":
        return j, t_
    kw = dict(n_layers=3, d_model=160, n_heads=2, n_kv_heads=2, d_ff=320,
              vocab_size=64, frontend_dim=24, head_dim=80)
    return dataclasses.replace(j, **kw), dataclasses.replace(t_, **kw)


_MODELS: dict = {}


def _model(name: str):
    """(jax cfg, torch cfg, jax params, torch params), built once each."""
    if name not in _MODELS:
        jcfg, tcfg = _cfgs(name)
        jp = JModel(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
        _MODELS[name] = (jcfg, tcfg, jp, tp)
    return _MODELS[name]


def _batch(cfg, seed: int, s: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"frames": randn(rng, B, s, cfg.frontend_dim),
            "labels": rng.integers(-1, cfg.vocab_size, size=(B, s))}


NAMES = ["smoke", "narrow"]
SEQS = {"smoke": 40, "narrow": 150}


@pytest.mark.parametrize("name", NAMES)
def test_audio_frontend_matches_reference(name):
    jcfg, tcfg, jp, tp = _model(name)
    batch = _batch(jcfg, 1, SEQS[name])
    want = JModel(jcfg)._frontend(jp, {"frames": jnp.asarray(
        batch["frames"])})
    got = Model(tcfg)._frontend(tp, {"frames": t(batch["frames"])})
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_apply_logits_match_reference(name):
    jcfg, tcfg, jp, tp = _model(name)
    frames = _batch(jcfg, 2, SEQS[name])["frames"]
    want, _ = jax.jit(JModel(jcfg).apply)(jp, {"frames": jnp.asarray(frames)})
    got, aux = Model(tcfg).apply(tp, {"frames": t(frames)})
    assert got.dtype == torch.float32
    assert got.shape == (B, SEQS[name], jcfg.vocab_size) and float(aux) == 0
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_tree_matches_reference(name):
    """From a bf16 tree the port takes fp32 frames in the parameters'
    type; the reference, whose conv refuses fp32 frames against bf16
    weights, is given them in bf16. Logits within 2e-2 of the largest."""
    jcfg, tcfg, _, _ = _model(name)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0), jnp.bfloat16)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    frames = _batch(jcfg, 7, SEQS[name])["frames"]
    want, _ = jax.jit(JModel(jcfg).apply)(
        jp, {"frames": jnp.asarray(frames, jnp.bfloat16)})
    got, _ = Model(tcfg).apply(tp, {"frames": t(frames)})
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and np.isfinite(n(got)).all()
    np.testing.assert_allclose(n(got), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name):
    """``Model.loss`` (labels of -1 masked) and every grad leaf, each
    within 1e-4 of its largest JAX grad, against ``jax.value_and_grad``."""
    jcfg, tcfg, jp, tp = _model(name)
    batch = _batch(jcfg, 3, SEQS[name])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jg = jax.jit(jax.value_and_grad(JModel(jcfg).loss,
                                                has_aux=True))(jp, jbatch)
    (loss, _), grads = value_and_grad(
        Model(tcfg), tp, {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(jg)
    got = jax.tree_util.tree_leaves_with_path(grads)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        if "'embed'" in jax.tree_util.keystr(path):   # unused: zero grads
            assert not w.any() and not n(g).any()
            continue
        limit = 1e-4 * float(np.abs(w).max())
        assert limit > 0 and float(np.abs(n(g) - w).max()) <= limit, \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("name", NAMES)
def test_step_builders_match_reference(name):
    """``make_prefill_step``'s greedy token after the last frame and
    ``make_eval_step``'s loss, against the reference's builders."""
    jcfg, tcfg, jp, tp = _model(name)
    batch = _batch(jcfg, 4, SEQS[name])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: t(v) for k, v in batch.items()}
    want = jax.jit(jax_prefill(JModel(jcfg)))(jp, {"frames": jbatch["frames"]})
    got = make_prefill_step(Model(tcfg))(tp, {"frames": tbatch["frames"]})
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    np.testing.assert_array_equal(n(got), n(want))
    jm = jax.jit(jax_eval(JModel(jcfg)))(jp, jbatch)
    tm = make_eval_step(Model(tcfg))(tp, tbatch)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_bit_for_bit(name):
    jcfg, tcfg, jp, tp = _model(name)
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jp)):
        assert torch.equal(a, _to_tensor(np.asarray(b)))
    assert Model(tcfg).param_count() == JModel(jcfg).param_count()


def test_full_tree_converts_on_meta():
    """HuBERT-XLarge's full tree (0.959 B parameters, 3.84 GB in fp32):
    JAX's shapes from eval_shape, handed over as zero-stride views, land
    on ``meta`` path for path, and both packages count the same
    parameters."""
    jcfg, tcfg = jax_arch(ARCH), get_arch(ARCH)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), shape=s.shape,
            strides=(0,) * len(s.shape)), shapes)
    tp = params_from_jax(views, tcfg, device="meta")
    want = jax.tree_util.tree_leaves_with_path(shapes)
    got = jax.tree_util.tree_leaves_with_path(tp)
    assert [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in got] == \
        [(jax.tree_util.keystr(p), tuple(s.shape)) for p, s in want]
    assert all(x.device.type == "meta" for _, x in got)
    assert tuple(tp["frontend"]["convpos"]["w"].shape) == (128, 80, 1280)
    assert sum(x.numel() for _, x in got) == FULL_PARAMS
    assert Model(tcfg).param_count() == JModel(jcfg).param_count() == \
        FULL_PARAMS


def test_decode_is_refused_as_the_reference_refuses_it():
    """An encoder-only config has no decode step: the reference's
    ``supports`` says so for a decode shape and its launcher raises
    ValueError with that reason; the port's ``decode_step``,
    ``init_cache`` and ``Server`` raise the same."""
    jcfg = jax_arch(ARCH)
    ok, why = jcfg.supports(JSHAPES["decode_32k"])
    assert not ok and why == "encoder-only architecture has no decode step"
    with pytest.raises(ValueError, match=why):
        build_dryrun(ARCH, "decode_32k", None)
    assert get_arch(ARCH).supports(JSHAPES["decode_32k"]) == (ok, why)
    _, tcfg, _, tp = _model("smoke")
    model = Model(tcfg)
    with pytest.raises(ValueError, match=why):
        model.init_cache(B, 8, device="cpu")
    with pytest.raises(ValueError, match=why):
        model.decode_step(tp, [], torch.zeros(B, 1, dtype=torch.long))
    with pytest.raises(ValueError, match=why):
        Server(ARCH, device="cpu")


# --------------------------------------------------------------------------
# flash attention at D=80
# --------------------------------------------------------------------------

FLASH80 = [  # b, kv, g, s, causal, window
    (2, 2, 1, 200, False, None),     # HuBERT's: non-causal, G=1, S ragged
    (1, 1, 2, 130, True, 48),        # a causal window over a ragged tail
]


def _flash_args(seed, b, kv, g, s, dtype):
    arrays = flash_inputs(seed, b, kv, g, s, 80)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    return ([jnp.asarray(a, jdt) for a in arrays],
            [t(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("fn", ["plain", "3xtf32", "bf16_2part"])
@pytest.mark.parametrize("b,kv,g,s,causal,window", FLASH80)
def test_flash_d80_matches_jax_kernel_and_oracle(b, kv, g, s, causal, window,
                                                 fn):
    """The plain version (fp32 and bf16) and each instance's arithmetic
    on its own input type against the Pallas kernel in interpret mode and
    ``flash_attention_ref``, at ``_tol``'s 2e-5 (fp32) and 2e-2 (bf16)."""
    dtype = "bfloat16" if fn == "bf16_2part" else "float32"
    for dt in (["float32", "bfloat16"] if fn == "plain" else [dtype]):
        jargs, targs = _flash_args(b + s, b, kv, g, s, dt)
        got = {"plain": ops.flash_attention,
               "3xtf32": FK.flash_attention_3xtf32,
               "bf16_2part": FK.flash_attention_bf16_2part}[fn](
                   *targs, causal=causal, window=window)
        assert got.dtype == targs[0].dtype
        assert got.shape == (b, kv * g, s, 80)
        kernel = jax_flash_attention(*jargs, causal=causal, window=window,
                                     bq=64, bk=64, interpret=True)
        oracle = jref.flash_attention_ref(*jargs, causal=causal,
                                          window=window)
        for want in (kernel, oracle):
            np.testing.assert_allclose(n(got.float()),
                                       n(want.astype(jnp.float32)),
                                       **ATTN_TOL[dt])


def test_flash_bf16_2part_within_limit_of_3xtf32_at_d80():
    """At D=80 as at the other head dims, the bf16 route on bf16 inputs is
    within ``bf16_limit`` of the fp32 instance's arithmetic on the widened
    inputs, and the one-part control is not."""
    q, k, v = (t(a).to(torch.bfloat16)
               for a in flash_inputs(80, 2, 2, 1, 200, 80))
    wide = FK.flash_attention_3xtf32(q.float(), k.float(), v.float(),
                                     causal=False)
    limit = FK.bf16_limit(wide, v)
    for parts, within in ((2, True), (1, False)):
        got = FK.flash_attention_bf16_2part(q, k, v, causal=False,
                                            parts=parts)
        share = ((got.float() - wide).abs() / limit).max().item()
        assert (share <= 0.5 + 2.0 ** -8) == within, (parts, share)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_geometry_at_the_hubert_shape(dtype):
    """HuBERT-XLarge's encoder (B=8 clips of S=1500 frames, 16 heads over
    16 KV heads of 80, non-causal): 12 tiles of 128 rows a head (the last
    of 92 rows), 1536 CTAs; every tile walks all 47 key blocks (the last
    of 28 keys), in order; each head copies its 1500 K and V rows once a
    tile. Shared memory: fp32 rows at pitches 80 (Q, K) and 100 (V),
    64,000 B; bf16 all at 88, 33,792 B."""
    geo = FK.geometry(8, 16, 16, 1500, 1500, 80, False, None, dtype=dtype)
    el = 4 if dtype == torch.float32 else 2
    assert (geo.tiles, geo.ctas, geo.el) == (12, 1536, el)
    assert 1500 - 11 * 128 == 92 and 1500 - 46 * 32 == 28
    assert geo.order == tuple(range(12))
    assert {geo.key_range(tile) for tile in range(12)} == {(0, 47)}
    assert geo.key_rows == 12 * 1500 * 16 * 8
    assert geo.l2_bytes == geo.key_rows * 2 * 80 * el
    smem = {4: 64000, 2: 33792}[el]
    assert geo.smem_bytes == FK.smem_bytes(80, el) == smem
    assert geo.plan == (1536, 256, smem)
    assert FK.pitches(80, el) == ((80, 100) if el == 4 else (88, 88))
    # fp32 at 1 CTA a SM (its launch bounds), bf16 at 2
    assert (geo.ctas_per_sm, geo.waves) == ((1, 12) if el == 4 else (2, 6))


def test_head_dims_and_the_dims_still_refused():
    assert FK.HEAD_DIMS == (64, 80, 128, 256)
    for d in (96, 112):              # MLA's q.k dim; another multiple of 16
        with pytest.raises(ValueError, match="not one of"):
            FK.geometry(1, 1, 1, 64, 64, d)


# --------------------------------------------------------------------------
# chip_smoke.py's helpers on an audio tree
# --------------------------------------------------------------------------

def test_one_ulp_moved_moves_the_frame_projection():
    """An audio model reads the frames' projection first, not the
    embedding table: ``one_ulp_moved`` steps each of its elements to the
    next value of its type, away from zero, and leaves the rest."""
    cs = chip_smoke()
    _, tcfg, _, tp = _model("smoke")
    for dtype, ints in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        params = jax.tree_util.tree_map(lambda x: x.to(dtype), tp)
        moved = cs.one_ulp_moved(params)
        proj, got = params["frontend"]["proj"], moved["frontend"]["proj"]
        assert torch.equal(got.view(ints), proj.view(ints) + 1)
        assert torch.all(got.abs() > proj.abs())
        assert moved["frontend"]["convpos"] is params["frontend"]["convpos"]
        assert moved["embed"] is params["embed"]
        assert moved["stages"] is params["stages"]
        frames = t(_batch(tcfg, 6, 40)["frames"]).to(dtype)
        a = Model(tcfg).apply(params, {"frames": frames})[0]
        b = Model(tcfg).apply(moved, {"frames": frames})[0]
        assert 0 < (a - b).abs().max().item() < 1e-2 * a.abs().max().item()
