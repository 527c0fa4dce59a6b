"""The port's RecurrentGemma model against ``repro.models.Model`` on
parameters copied by ``params_from_jax``: the configs, the forward logits
past the local-attention window, 40 decode steps through the ring buffer,
both step builders, the stacked stage, the caches, and the parameter
conversion of both configs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import (MODEL_TOL, _reset_port, jax_params,  # noqa: E402,F401
                           n, torch_params)

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro.train import make_serve_step as jax_serve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

ARCH = "recurrentgemma-9b"
B = 2


@pytest.fixture(scope="module")
def smoke():
    """(jax cfg, torch cfg, jax params, torch params) of the smoke model."""
    jcfg, tcfg = jax_arch(ARCH, smoke=True), get_arch(ARCH, smoke=True)
    jp, npp = jax_params(jcfg, seed=0)
    return jcfg, tcfg, jp, torch_params(npp, tcfg)


def _tokens(seed, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, s))


@pytest.mark.parametrize("smoke_", [False, True])
def test_configs_match_reference(smoke_):
    j, t_ = jax_arch(ARCH, smoke=smoke_), get_arch(ARCH, smoke=smoke_)
    assert t_.stages == j.stages
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size", "head_dim", "layer_pattern", "attn_window",
                 "rope_kind", "rope_theta", "mlp_kind", "norm", "norm_eps",
                 "tie_embeddings", "logits_softcap", "causal"):
        assert getattr(t_, name) == getattr(j, name), name
    assert (t_.rglru.d_model, t_.rglru.lru_width, t_.rglru.conv_width) == \
        (j.rglru.d_model, j.rglru.lru_width, j.rglru.conv_width)


def test_stages_stack_a_repeated_unit(smoke):
    _, tcfg, _, tp = smoke
    assert tcfg.stages == ((("rglru", "rglru", "lattn"), 1), (("rglru",), 2))
    assert get_arch(ARCH).stages == ((("rglru", "rglru", "lattn"), 12),
                                     (("rglru",), 2))
    stacked = tp["stages"][1]["b0"]
    assert stacked["rec"]["w_a"].shape == (2, 64, 64)
    assert stacked["ln1"]["scale"].shape == (2, 64)


@pytest.mark.parametrize("s", [32, 48])
def test_apply_logits_match_reference(smoke, s):
    """Both lengths are past the smoke config's window of 16."""
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(s, s, jcfg.vocab_size)
    want, _ = jax.jit(JModel(jcfg).apply)(jp, {"tokens": jnp.asarray(toks)})
    got, aux = Model(tcfg).apply(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, s, jcfg.vocab_size)
    assert float(aux) == 0.0
    assert float(got.abs().max()) <= tcfg.logits_softcap
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)


def test_decode_40_steps_match_reference_and_own_prefill(smoke):
    """40 steps wrap the 16-slot ring buffer twice; every step's logits and
    the final (stacked) caches agree with JAX's decode_step, and the last
    step agrees with the port's own prefill."""
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(1, 40, jcfg.vocab_size)
    jm, tm = JModel(jcfg), Model(tcfg)
    jcache = jm.init_cache(B, max_seq=64, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_seq=64, device="cpu", dtype=torch.float32)
    step = jax.jit(jm.decode_step)
    for i in range(40):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(n(tl), n(jl), **MODEL_TOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in tleaves] == \
        [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (_, a), (_, b) in zip(tleaves, jleaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(n(a), n(b), **MODEL_TOL)
    full, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(n(tl[:, 0]), n(full[:, -1]), **MODEL_TOL)


@pytest.mark.parametrize("max_seq,dtype", [(64, "bfloat16"), (8, "float32")])
def test_init_cache_matches_reference(max_seq, dtype):
    """The lattn cache holds min(max_seq, window) positions in the given
    type, the recurrent state is fp32, and stacked stages stack it."""
    jcfg, tcfg = jax_arch(ARCH, smoke=True), get_arch(ARCH, smoke=True)
    want = jax.eval_shape(
        lambda: JModel(jcfg).init_cache(3, max_seq, getattr(jnp, dtype)))
    got = Model(tcfg).init_cache(3, max_seq, device="cpu",
                                 dtype=getattr(torch, dtype))
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in tl] == \
        [jax.tree_util.keystr(p) for p, _ in jl]
    for (_, a), (_, b) in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    with pytest.raises(ValueError, match="max_seq"):
        Model(tcfg).init_cache(1, device="cpu")


def test_prefill_step_tokens_match_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(2, 48, jcfg.vocab_size)
    want = jax.jit(jax_prefill(JModel(jcfg)))(jp,
                                              {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(Model(tcfg))(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    np.testing.assert_array_equal(n(got), n(want))


def test_serve_step_tokens_match_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    jm, tm = JModel(jcfg), Model(tcfg)
    jstep, tstep = jax.jit(jax_serve(jm)), make_serve_step(tm)
    jcache = jm.init_cache(B, max_seq=32, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_seq=32, device="cpu", dtype=torch.float32)
    jt = jnp.asarray(_tokens(3, 1, jcfg.vocab_size), jnp.int32)
    tt = torch.from_numpy(np.array(jt))
    for _ in range(24):                   # feed each step its own output
        jt, jcache = jstep(jp, jcache, jt)
        tt, tcache = tstep(tp, tcache, tt)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
        np.testing.assert_array_equal(n(tt), n(jt))


@pytest.mark.parametrize("smoke_", [True, False])
def test_params_from_jax_maps_every_leaf(smoke_):
    """Every leaf of the JAX pytree, stacked stages included, maps onto the
    port's parameters with its shape. At full width (10.4 B parameters)
    nothing is materialised: the JAX shapes come from eval_shape and the
    leaves handed over are zero-stride views, held against the port's
    ``meta`` parameters."""
    jcfg, tcfg = jax_arch(ARCH, smoke=smoke_), get_arch(ARCH, smoke=smoke_)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), shape=s.shape, strides=(0,) * len(s.shape)),
        shapes)
    tp = params_from_jax(views, tcfg, device="cpu")
    want = jax.tree_util.tree_leaves_with_path(shapes)
    got = jax.tree_util.tree_leaves_with_path(tp)
    meta = jax.tree_util.tree_leaves(
        Model(tcfg).init(torch.Generator(), device="meta"))
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert [tuple(x.shape) for _, x in got] == [tuple(s.shape)
                                                for _, s in want]
    assert [tuple(x.shape) for x in meta] == [tuple(s.shape)
                                              for _, s in want]
    assert Model(tcfg).param_count() == JModel(jcfg).param_count()
    if not smoke_:
        assert Model(tcfg).param_count() == 10_444_984_320


def test_params_from_jax_rejects_a_stage_without_its_stack(smoke):
    jcfg, tcfg, jp, _ = smoke
    npp = jax.tree_util.tree_map(np.asarray, jp)
    unstacked = jax.tree_util.tree_map(lambda a: a[0], npp["stages"][1])
    bad = dict(npp, stages=[npp["stages"][0], unstacked])
    with pytest.raises(ValueError, match="stages/1/b0/.*shape"):
        params_from_jax(bad, tcfg, device="cpu")


def test_init_is_seeded_and_stacks_distinct_repeats():
    cfg = get_arch(ARCH, smoke=True)
    a = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    b = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    torch.testing.assert_close(a, b)
    stacked = a["stages"][1]["b0"]["rec"]["w_in"]
    assert stacked.shape == (2, 64, 64)
    assert not torch.equal(stacked[0], stacked[1])
