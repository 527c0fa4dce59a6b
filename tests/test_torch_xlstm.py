"""The port's xLSTM blocks against ``repro.models.xlstm`` on the same
numpy inputs and parameters: both forms of the mLSTM (parallel below 512
tokens, chunkwise from 512), the sLSTM scan, and both blocks with and
without a cache."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import (MLSTM_TOL, MODEL_TOL, SLSTM_TOL,  # noqa: E402,F401
                           _reset_port, n, randn, t)

from repro.models import layers as JL  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

JDIMS = JX.XLSTMDims(d_model=64, n_heads=2)
TDIMS = TX.XLSTMDims(d_model=64, n_heads=2)
B = 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _block_params(init, seed):
    p = _np_tree(init(jax.random.PRNGKey(seed), JDIMS))
    return jax.tree_util.tree_map(jnp.asarray, p), _torch_tree(p)


def _cache(rng, shapes):
    """A non-trivial recurrent state: random, with positive normalisers."""
    out = {}
    for k, shape in shapes.items():
        a = randn(rng, *shape, scale=0.5)
        out[k] = np.abs(a) + 1.0 if k == "n" else a
    return out


def test_dims_match_reference():
    for name in ("d_inner", "head_dim"):
        assert getattr(TDIMS, name) == getattr(JDIMS, name)
    full = TX.XLSTMDims(d_model=768, n_heads=4)
    assert (full.head_dim, full.d_model // full.n_heads) == (384, 192)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm):
    rng = np.random.default_rng(0)
    x = randn(rng, 3, 5, 64, scale=3.0, shift=1.0)
    p = {"scale": randn(rng, 64), "bias": randn(rng, 64)}
    jf, tf = getattr(JL, norm), getattr(TL, norm)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    if norm == "rmsnorm":
        jp.pop("bias"), tp.pop("bias")
    np.testing.assert_allclose(n(tf(tp, t(x))), n(jf(jp, jnp.asarray(x))),
                               rtol=2e-5, atol=2e-5)


def test_mlstm_parallel_and_chunkwise_forms_match_reference():
    rng = np.random.default_rng(1)
    b, h, s, d = 1, 2, 256, 32
    args = [randn(rng, b, h, s, d) for _ in range(3)] + \
        [randn(rng, b, h, s), randn(rng, b, h, s, shift=2.0)]
    jargs, targs = [jnp.asarray(a) for a in args], [t(a) for a in args]
    np.testing.assert_allclose(n(TX.mlstm_parallel_ref(*targs)),
                               n(JX.mlstm_parallel_ref(*jargs)), **MLSTM_TOL)
    np.testing.assert_allclose(n(TX.mlstm_chunkwise(*targs, cs=64)),
                               n(JX.mlstm_chunkwise(*jargs, cs=64)),
                               **MLSTM_TOL)


def test_mlstm_decode_step_matches_reference():
    rng = np.random.default_rng(2)
    b, h, d = 2, 2, 16
    state = _cache(rng, {"C": (b, h, d, d), "n": (b, h, d), "m": (b, h)})
    args = [randn(rng, b, h, d) for _ in range(3)] + \
        [randn(rng, b, h), randn(rng, b, h, shift=2.0)]
    jstate, jh = JX.mlstm_decode_step(
        {k: jnp.asarray(v) for k, v in state.items()},
        *(jnp.asarray(a) for a in args))
    tstate, th = TX.mlstm_decode_step({k: t(v) for k, v in state.items()},
                                      *(t(a) for a in args))
    np.testing.assert_allclose(n(th), n(jh), rtol=2e-5, atol=2e-5)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(n(tstate[k]), n(jstate[k]),
                                   rtol=2e-5, atol=2e-5)


def test_dw_conv_with_state_matches_reference():
    rng = np.random.default_rng(3)
    x, w, bias = randn(rng, 2, 5, 8), randn(rng, 4, 8), randn(rng, 8)
    state = randn(rng, 2, 3, 8)
    jo, js = JX._dw_conv(*(jnp.asarray(a) for a in (x, w, bias, state)))
    to, ts = TX._dw_conv(*(t(a) for a in (x, w, bias, state)))
    np.testing.assert_allclose(n(to), n(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(n(ts), n(js))


@pytest.mark.parametrize("s", [64, 512])
def test_mlstm_block_matches_reference(s):
    """S=64 takes the parallel form, S=512 the chunkwise form (the kernel
    path; its plain version on the CPU)."""
    jp, tp = _block_params(JX.mlstm_block_init, 4)
    x = randn(np.random.default_rng(s), B, s, 64)
    jo, jc = JX.mlstm_block_apply(jp, jnp.asarray(x), JDIMS)
    to, tc = TX.mlstm_block_apply(tp, t(x), TDIMS)
    assert jc is None and tc is None
    np.testing.assert_allclose(n(to), n(jo), **MODEL_TOL)


def test_mlstm_block_with_cache_matches_reference():
    jp, tp = _block_params(JX.mlstm_block_init, 5)
    rng = np.random.default_rng(5)
    hd, di = JDIMS.head_dim, JDIMS.d_inner
    cache = _cache(rng, {"C": (B, 2, hd, hd), "n": (B, 2, hd), "m": (B, 2),
                         "conv": (B, 3, di)})
    x = randn(rng, B, 1, 64)
    jo, jc = JX.mlstm_block_apply(
        jp, jnp.asarray(x), JDIMS,
        cache={k: jnp.asarray(v) for k, v in cache.items()})
    to, tc = TX.mlstm_block_apply(tp, t(x), TDIMS,
                                  cache={k: t(v) for k, v in cache.items()})
    np.testing.assert_allclose(n(to), n(jo), **MODEL_TOL)
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(n(tc[k]), n(jc[k]), **MODEL_TOL)


@pytest.mark.parametrize("s", [64, 512])
def test_slstm_block_matches_reference(s):
    jp, tp = _block_params(JX.slstm_block_init, 6)
    x = randn(np.random.default_rng(s + 1), B, s, 64)
    jo, jc = JX.slstm_block_apply(jp, jnp.asarray(x), JDIMS)
    to, tc = TX.slstm_block_apply(tp, t(x), TDIMS)
    assert jc is None and tc is None
    np.testing.assert_allclose(n(to), n(jo), **MODEL_TOL)


@pytest.mark.parametrize("s", [1, 8])
def test_slstm_block_with_cache_matches_reference(s):
    jp, tp = _block_params(JX.slstm_block_init, 7)
    rng = np.random.default_rng(7 + s)
    cache = _cache(rng, {k: (B, 2, 32) for k in ("c", "n", "hs", "m")})
    x = randn(rng, B, s, 64)
    jo, jc = JX.slstm_block_apply(
        jp, jnp.asarray(x), JDIMS,
        cache={k: jnp.asarray(v) for k, v in cache.items()})
    to, tc = TX.slstm_block_apply(tp, t(x), TDIMS,
                                  cache={k: t(v) for k, v in cache.items()})
    np.testing.assert_allclose(n(to), n(jo), **MODEL_TOL)
    for k in jc:
        np.testing.assert_allclose(n(tc[k]), n(jc[k]), **MODEL_TOL)


def test_slstm_scan_zero_state_matches_reference():
    jp, tp = _block_params(JX.slstm_block_init, 8)
    x = randn(np.random.default_rng(8), B, 32, 64)
    jh, _ = JX.slstm_scan(jp, jnp.asarray(x), 2)
    th, final = TX.slstm_scan(tp, t(x), 2)
    assert final is None           # the kernel path returns no final state
    np.testing.assert_allclose(n(th), n(jh), **SLSTM_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cache_init_shapes_match_reference(kind):
    jc = getattr(JX, f"{kind}_cache_init")(3, JDIMS)
    tc = getattr(TX, f"{kind}_cache_init")(3, TDIMS)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert all(v.dtype == torch.float32 and not v.any() for v in tc.values())


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_init_shapes_match_reference(kind):
    jp = getattr(JX, f"{kind}_block_init")(jax.random.PRNGKey(0), JDIMS)
    tp = getattr(TX, f"{kind}_block_init")(torch.Generator().manual_seed(0),
                                           TDIMS)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tp) == shapes
    bf = n(tp["b_f"])
    assert np.all(bf == 3.0)       # forget gate starts near 1
