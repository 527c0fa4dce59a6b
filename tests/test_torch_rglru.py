"""The port's RecurrentGemma layers against ``repro.models.rglru`` and
``repro.models.layers`` on the same numpy inputs and parameters: RoPE, the
masked attention path, the attention block for prefill and for a
ring-buffer decode, the MLP, the causal conv and the RG-LRU block with and
without a cache."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from _torch_parity import (MODEL_TOL, _reset_port, n, randn,  # noqa: E402,F401
                           t)

from repro.models import layers as JL  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402

D_MODEL, WIDTH, B = 64, 64, 2
JDIMS = JR.RGLRUDims(d_model=D_MODEL, lru_width=WIDTH)
TDIMS = TR.RGLRUDims(d_model=D_MODEL, lru_width=WIDTH)
JATT = JL.AttnDims(D_MODEL, 4, 1, 16)
TATT = TL.AttnDims(D_MODEL, 4, 1, 16)
WINDOW = 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _params(init, seed):
    p = _np_tree(init(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(jnp.asarray, p), _torch_tree(p)


def test_dims_match_reference():
    assert dataclasses.asdict(TDIMS) == dataclasses.asdict(JDIMS)
    assert dataclasses.asdict(TATT) == dataclasses.asdict(JATT)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; the erf form differs by
    ~4e-4 on [-3, 3], over the model tolerance."""
    x = np.linspace(-3, 3, 601, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(n(F.gelu(t(x), approximate="tanh")), want,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(n(F.gelu(t(x))) - want).max() > 1e-4


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(0)
    x = randn(rng, B, 40, 4, 16)
    pos = np.stack([np.arange(40), np.arange(40) + 3000]).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(t(x), t(pos), theta)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(TL.rope_freqs(16, theta),
                                  JL.rope_freqs(16, theta))


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, None, None), (True, 8, None), (False, None, [5, 24])])
def test_sdpa_matches_reference(causal, window, kv_len):
    rng = np.random.default_rng(1)
    q = randn(rng, B, 24, 4, 16)
    k, v = randn(rng, B, 24, 1, 16), randn(rng, B, 24, 1, 16)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window,
                   kv_len=None if kl is None else jnp.asarray(kl))
    got = TL.sdpa(t(q), t(k), t(v), causal=causal, window=window,
                  kv_len=None if kl is None else t(kl))
    np.testing.assert_allclose(n(got), n(want), rtol=2e-5, atol=2e-5)


def test_mlp_matches_reference():
    jp, tp = _params(lambda key: JL.mlp_init(key, D_MODEL, 128, "swiglu"), 2)
    x = randn(np.random.default_rng(2), B, 8, D_MODEL)
    want = JL.mlp_apply(jp, jnp.asarray(x), "swiglu")
    np.testing.assert_allclose(n(TL.mlp_apply(tp, t(x), "swiglu")), n(want),
                               **MODEL_TOL)


@pytest.mark.parametrize("kind", ["gelu", "squared_relu"])
def test_other_mlp_kinds_name_their_family(kind):
    """The ungated kinds match the reference: gelu came with HuBERT's slice
    (the tanh GELU, as ``jax.nn.gelu`` defaults to), squared_relu with
    Nemotron-4's (the GQA slice)."""
    jp, tp = _params(lambda key: JL.mlp_init(key, D_MODEL, 128, kind), 2)
    assert sorted(tp) == ["w_down", "w_up"]
    x = randn(np.random.default_rng(2), B, 8, D_MODEL)
    want = JL.mlp_apply(jp, jnp.asarray(x), kind)
    np.testing.assert_allclose(n(TL.mlp_apply(tp, t(x), kind)), n(want),
                               **MODEL_TOL)


@pytest.mark.parametrize("s", [48, 1])
def test_attention_prefill_matches_reference(s):
    """Local attention over a prompt longer than the window."""
    jp, tp = _params(lambda key: JL.attention_init(key, JATT), 3)
    x = randn(np.random.default_rng(3), B, s, D_MODEL)
    want, _ = JL.attention_apply(jp, jnp.asarray(x), JATT, rope_theta=1e4,
                                 window=WINDOW)
    got, cache = TL.attention_apply(tp, t(x), TATT, rope_theta=1e4,
                                    window=WINDOW)
    assert cache is None
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_ring_buffer_matches_reference(dtype):
    """40 decode steps into a 16-slot ring buffer (it wraps twice), rows
    at different positions; every step's output and the final cache agree
    with the JAX block."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp, tp = _params(lambda key: JL.attention_init(key, JATT), 4)
    jc = JL.attention_cache_init(B, WINDOW, JATT, jdt)
    jc["pos"] = jnp.asarray([0, 5], jnp.int32)
    tc = TL.attention_cache_init(B, WINDOW, TATT, tdt)
    tc["pos"] = torch.tensor([0, 5], dtype=torch.int32)
    rng = np.random.default_rng(4)
    jstep = jax.jit(functools.partial(JL.attention_apply, dims=JATT,
                                      rope_theta=1e4, window=WINDOW))
    for _ in range(40):
        x = randn(rng, B, 1, D_MODEL)
        want, jc = jstep(jp, jnp.asarray(x), cache=jc)
        got, tc = TL.attention_apply(tp, t(x), TATT, rope_theta=1e4,
                                     window=WINDOW, cache=tc)
        np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)
    assert tc["k"].dtype == tdt and tc["pos"].dtype == torch.int32
    np.testing.assert_array_equal(n(tc["pos"]), n(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(n(tc[key].float()),
                                   n(jc[key].astype(jnp.float32)),
                                   **MODEL_TOL)


def test_attention_decode_matches_own_prefill_past_the_window():
    _, tp = _params(lambda key: JL.attention_init(key, JATT), 5)
    x = t(randn(np.random.default_rng(5), B, 40, D_MODEL))
    full, _ = TL.attention_apply(tp, x, TATT, rope_theta=1e4, window=WINDOW)
    cache = TL.attention_cache_init(B, WINDOW, TATT, torch.float32)
    outs = []
    for i in range(40):
        o, cache = TL.attention_apply(tp, x[:, i:i + 1], TATT,
                                      rope_theta=1e4, window=WINDOW,
                                      cache=cache)
        outs.append(o)
    np.testing.assert_allclose(n(torch.cat(outs, 1)), n(full), **MODEL_TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(6)
    x, w, b = (randn(rng, B, 12, WIDTH), randn(rng, 4, WIDTH),
               randn(rng, WIDTH))
    state = randn(rng, B, 3, WIDTH)
    for st in (None, state):
        want, wst = JR._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b),
                                      None if st is None else jnp.asarray(st))
        got, gst = TR._causal_conv1d(t(x), t(w), t(b),
                                     None if st is None else t(st))
        np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(n(gst), n(wst), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [1, 32])
def test_rglru_block_matches_reference(s):
    jp, tp = _params(lambda key: JR.rglru_block_init(key, JDIMS), 7)
    x = randn(np.random.default_rng(7), B, s, D_MODEL)
    want, _ = JR.rglru_block_apply(jp, jnp.asarray(x), JDIMS)
    got, cache = TR.rglru_block_apply(tp, t(x), TDIMS)
    assert cache is None
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)


@pytest.mark.parametrize("s", [1, 8])
def test_rglru_block_with_cache_matches_reference(s):
    jp, tp = _params(lambda key: JR.rglru_block_init(key, JDIMS), 8)
    rng = np.random.default_rng(8)
    x = randn(rng, B, s, D_MODEL)
    cache = {"h": randn(rng, B, WIDTH, scale=0.5),
             "conv": randn(rng, B, 3, WIDTH, scale=0.5)}
    want, wc = JR.rglru_block_apply(
        jp, jnp.asarray(x), JDIMS,
        cache={k: jnp.asarray(v) for k, v in cache.items()})
    got, gc = TR.rglru_block_apply(tp, t(x), TDIMS,
                                   cache={k: t(v) for k, v in cache.items()})
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(n(gc[key]), n(wc[key]), **MODEL_TOL)
    empty = TR.rglru_cache_init(B, TDIMS)
    jempty = JR.rglru_cache_init(B, JDIMS)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in jempty.items()}


def test_rglru_init_is_seeded_in_the_paper_range():
    a = TR.rglru_block_init(torch.Generator().manual_seed(1), TDIMS)
    b = TR.rglru_block_init(torch.Generator().manual_seed(1), TDIMS)
    torch.testing.assert_close(a, b)
    decay = torch.sigmoid(a["lambda"])
    assert a["lambda"].dtype == torch.float32
    assert bool(((decay >= 0.9 - 1e-6) & (decay <= 0.999 + 1e-6)).all())
    ref_shapes = jax.eval_shape(lambda k: JR.rglru_block_init(k, JDIMS),
                                jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(v.shape) for k, v in ref_shapes.items()}
