"""The port's xLSTM model against ``repro.models.Model``: forward logits,
the decode sequence, both step builders, and the parameter conversion at
full width."""

import dataclasses

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
from repro_torch.configs import ArchConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.mla import MLADims  # noqa: E402
from repro_torch.models.moe import MoEDims  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

ARCH = "xlstm-125m"
B = 2


@pytest.fixture(scope="module")
def smoke():
    """(jax cfg, torch cfg, jax params, torch params) of the smoke model."""
    jcfg, tcfg = jax_arch(ARCH, smoke=True), get_arch(ARCH, smoke=True)
    jp, npp = jax_params(jcfg, seed=0)
    return jcfg, tcfg, jp, torch_params(npp, tcfg)


def _tokens(seed, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, s))


def test_configs_match_reference():
    for smoke_ in (False, True):
        j, t_ = jax_arch(ARCH, smoke=smoke_), get_arch(ARCH, smoke=smoke_)
        assert t_.stages == j.stages
        for name in ("d_model", "n_heads", "vocab_size", "norm", "norm_eps",
                     "tie_embeddings", "layer_pattern"):
            assert getattr(t_, name) == getattr(j, name)
        assert (t_.xlstm.head_dim, t_.xlstm.d_inner) == \
            (j.xlstm.head_dim, j.xlstm.d_inner)


@pytest.mark.parametrize("s", [32, 512])
def test_apply_logits_match_reference(smoke, s):
    """S=32 runs the parallel mLSTM form, S=512 the chunkwise (kernel) form
    in both packages."""
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(s, s, jcfg.vocab_size)
    want, _ = jax.jit(JModel(jcfg).apply)(jp, {"tokens": jnp.asarray(toks)})
    got, aux = Model(tcfg).apply(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, s, jcfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)


def test_decode_sequence_matches_reference_and_own_prefill(smoke):
    """Mirror of test_arch_smoke's decode-vs-prefill check, plus parity of
    every decode step's logits and final cache with JAX."""
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(1, 8, jcfg.vocab_size)
    jm, tm = JModel(jcfg), Model(tcfg)
    jcache = jm.init_cache(B, max_seq=16, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_seq=16, device="cpu")
    step = jax.jit(jm.decode_step)
    for i in range(8):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(n(tl), n(jl), **MODEL_TOL)
    jleaves = jax.tree_util.tree_leaves(jcache)
    tleaves = jax.tree_util.tree_leaves(tcache)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(n(a), n(b), **MODEL_TOL)
    full, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(n(tl[:, 0]), n(full[:, -1]), **MODEL_TOL)


def test_prefill_step_tokens_match_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(2, 512, jcfg.vocab_size)
    want = jax.jit(jax_prefill(JModel(jcfg)))(jp,
                                              {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(Model(tcfg))(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    np.testing.assert_array_equal(n(got), n(want))


def test_serve_step_tokens_match_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    jm, tm = JModel(jcfg), Model(tcfg)
    jstep, tstep = jax.jit(jax_serve(jm)), make_serve_step(tm)
    jcache = jm.init_cache(B, max_seq=16, dtype=jnp.float32)
    tcache = tm.init_cache(B, device="cpu")
    jt = jnp.asarray(_tokens(3, 1, jcfg.vocab_size), jnp.int32)
    tt = torch.from_numpy(np.array(jt))
    for _ in range(6):                    # feed each step its own output
        jt, jcache = jstep(jp, jcache, jt)
        tt, tcache = tstep(tp, tcache, tt)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
        np.testing.assert_array_equal(n(tt), n(jt))


def test_params_from_jax_full_width_shapes():
    """Every leaf of the full-width JAX pytree maps onto the port's
    parameters with its shape, without materialising any array: the JAX
    shapes come from eval_shape and the leaves handed over are zero-stride
    views."""
    jcfg, tcfg = jax_arch(ARCH), get_arch(ARCH)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    views = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), shape=s.shape, strides=(0,) * len(s.shape)),
        shapes)
    tp = params_from_jax(views, tcfg, device="cpu")
    want = jax.tree_util.tree_leaves_with_path(shapes)
    got = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert [tuple(x.shape) for _, x in got] == [tuple(s.shape)
                                                for _, s in want]
    assert Model(tcfg).param_count() == JModel(jcfg).param_count()


def test_params_from_jax_rejects_mismatches(smoke):
    jcfg, tcfg, jp, _ = smoke
    npp = jax.tree_util.tree_map(np.asarray, jp)
    bad = dict(npp, stages=[dict(npp["stages"][0])])
    del bad["stages"][0]["b1"]
    with pytest.raises(ValueError, match="missing leaves"):
        params_from_jax(bad, tcfg, device="cpu")
    extra = dict(npp, unembed={"table": npp["embed"]["table"]})
    with pytest.raises(ValueError, match="unused leaves"):
        params_from_jax(extra, tcfg, device="cpu")
    shape = dict(npp, embed={"table": npp["embed"]["table"][:, :8]})
    with pytest.raises(ValueError, match="embed/table: shape"):
        params_from_jax(shape, tcfg, device="cpu")


def test_init_is_seeded_and_placed():
    cfg = get_arch(ARCH, smoke=True)
    a = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    b = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    torch.testing.assert_close(a, b)
    cell = a["stages"][0]["b0"]["cell"]
    assert torch.all(cell["b_f"] == 3.0) and cell["w_up"].device.type == "cpu"


def test_other_block_kinds_name_their_slice():
    """An unknown kind is refused by name. ``attn`` and ``dense`` came with
    the GQA slice, ``moe`` with the MoE slice, ``mla`` with the MLA slice,
    the audio frontend with HuBERT's: each builds, and an ``mla`` block and
    an audio-fronted ``attn`` block run."""
    base = ArchConfig(name="tiny", family="dense", n_layers=1, d_model=8,
                      n_heads=2, n_kv_heads=2, d_ff=16, vocab_size=16,
                      scan_layers=False,
                      moe=MoEDims(d_model=8, n_experts=4, top_k=2,
                                  d_expert=8),
                      mla=MLADims(d_model=8, n_heads=2, q_lora_rank=6,
                                  kv_lora_rank=4, qk_nope_dim=2,
                                  qk_rope_dim=2, v_head_dim=3))
    audio = Model(dataclasses.replace(base, frontend="audio",
                                      frontend_dim=4, d_model=32,
                                      n_heads=2, n_kv_heads=2,
                                      pattern=("attn",)))
    params = audio.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["frontend"]["convpos"]["w"].shape == (128, 2, 32)
    logits, _ = audio.apply(params, {"frames": torch.ones(1, 5, 4)})
    assert logits.shape == (1, 5, 16) and torch.isfinite(logits).all()
    with pytest.raises(NotImplementedError, match="'conv'"):
        Model(dataclasses.replace(base, pattern=("conv",)))
    for kind in ("attn", "dense", "moe", "mla"):
        Model(dataclasses.replace(base, pattern=(kind,)))
    mla = Model(dataclasses.replace(base, pattern=("mla",)))
    params = mla.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["stages"][0]["b0"]["attn"]["wkv_b"].shape == (4, 2 * 5)
    logits, _ = mla.apply(params, {"tokens": torch.zeros(1, 3,
                                                         dtype=torch.long)})
    assert logits.shape == (1, 3, 16) and torch.isfinite(logits).all()
