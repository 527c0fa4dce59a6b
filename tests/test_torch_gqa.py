"""The port's GQA family (yi-9b, yi-34b, nemotron-4-340b, qwen2-vl-72b)
against ``repro.models.Model`` on parameters copied by ``params_from_jax``:
the configs, the forward logits (with M-RoPE positions and the vision stub
for Qwen2-VL), decode steps against JAX's and the port's own prefill, the
global cache past ``max_seq``, both step builders, qk-norm, the ``dense``
kind, the parameter conversion of the four full-width trees on ``meta``,
the Server on the CPU, and a mirror of tests/test_arch_smoke.py over every
ported arch."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import (MODEL_TOL, _reset_port, jax_params,  # noqa: E402,F401
                           jax_serve_example, n, serve_all, torch_params)

import repro.core as jrc  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro.train import make_serve_step as jax_serve  # noqa: E402
import repro_torch.core as rc  # noqa: E402
from repro_torch.configs import all_archs, get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import Server  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

GQA = ["yi-9b", "yi-34b", "nemotron-4-340b", "qwen2-vl-72b"]
TEXT = ["yi-9b", "yi-34b", "nemotron-4-340b"]
B = 2
# JAX's Model.param_count of each full config (fp32 leaves)
FULL_PARAMS = {"yi-9b": 8_829_407_232, "yi-34b": 34_388_917_248,
               "nemotron-4-340b": 341_025_638_400,
               "qwen2-vl-72b": 72_705_384_448}

_SMOKE: dict = {}


def _smoke(arch, jcfg=None, tcfg=None):
    """(jax cfg, torch cfg, jax params, torch params) of a smoke model,
    built once per config."""
    jcfg = jcfg or jax_arch(arch, smoke=True)
    tcfg = tcfg or get_arch(arch, smoke=True)
    if jcfg not in _SMOKE:
        jp, npp = jax_params(jcfg, seed=0)
        _SMOKE[jcfg] = (jcfg, tcfg, jp, torch_params(npp, tcfg))
    return _SMOKE[jcfg]


def _tokens(seed, s, vocab, b=B):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


def _batch(cfg, seed, s):
    """Tokens, and for M-RoPE a batch whose first P positions are an image
    of P patches on a 2 x 4 grid (t fixed, h and w moving, spaced widely
    so that each axis moves the logits well past the tolerance) followed
    by text, with P patch embeddings, all from numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, s))}
    if cfg.rope_kind == "mrope":
        p = 8
        t_ = np.concatenate([np.zeros(p), np.arange(s - p) + 40])
        h_ = np.concatenate([np.arange(p) // 4 * 29, np.arange(s - p) + 40])
        w_ = np.concatenate([np.arange(p) % 4 * 13, np.arange(s - p) + 40])
        pos = np.stack([t_, h_, w_]).astype(np.int32)
        out["positions"] = np.broadcast_to(pos[:, None], (3, B, s)).copy()
        out["vision_embeds"] = rng.standard_normal(
            (B, p, cfg.d_model)).astype(np.float32)
    return out


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("smoke_", [False, True])
@pytest.mark.parametrize("arch", GQA)
def test_configs_match_reference(arch, smoke_):
    j, t_ = jax_arch(arch, smoke=smoke_), get_arch(arch, smoke=smoke_)
    assert t_.stages == j.stages
    for name in ("name", "family", "n_layers", "d_model", "n_heads",
                 "n_kv_heads", "d_ff", "vocab_size", "head_dim",
                 "layer_pattern", "attn_window", "rope_kind", "rope_theta",
                 "mrope_sections", "mlp_kind", "frontend", "qk_norm", "norm",
                 "norm_eps", "tie_embeddings", "logits_softcap", "causal",
                 "decode_capable", "subquadratic", "source"):
        assert getattr(t_, name) == getattr(j, name), name


@pytest.mark.parametrize("s", [32, 160])
@pytest.mark.parametrize("arch", GQA)
def test_apply_logits_match_reference(arch, s):
    jcfg, tcfg, jp, tp = _smoke(arch)
    batch = _batch(jcfg, s, s)
    want, _ = jax.jit(JModel(jcfg).apply)(jp, _to_jax(batch))
    got, aux = Model(tcfg).apply(tp, _to_torch(batch))
    assert got.dtype == torch.float32 and got.shape == (B, s, jcfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)


def test_mrope_positions_and_vision_embeds_change_the_logits():
    """The Qwen2-VL batch's positions and patch embeddings are used: each
    moves the logits, and both agree with the reference (above)."""
    _, tcfg, _, tp = _smoke("qwen2-vl-72b")
    batch = _to_torch(_batch(tcfg, 1, 32))
    model = Model(tcfg)
    full, _ = model.apply(tp, batch)
    text = {"tokens": batch["tokens"],
            "positions": torch.arange(32).expand(3, B, 32)}
    no_pos = dict(batch, positions=text["positions"])
    no_img = {k: v for k, v in batch.items() if k != "vision_embeds"}
    for other in (no_pos, no_img):
        assert (model.apply(tp, other)[0] - full).abs().max() > 1e-3
    # without positions the text ids drive all three axes
    np.testing.assert_allclose(n(model.apply(tp, {"tokens": batch["tokens"]})
                                 [0]), n(model.apply(tp, text)[0]),
                               rtol=0, atol=0)


def _decode_both(jcfg, tcfg, jp, tp, toks, max_seq):
    """Every step's logits of both decode paths, and the final caches."""
    jm, tm = JModel(jcfg), Model(tcfg)
    jcache = jm.init_cache(B, max_seq=max_seq, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_seq=max_seq, device="cpu",
                           dtype=torch.float32)
    step = jax.jit(jm.decode_step)
    steps = []
    for i in range(toks.shape[1]):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]))
        steps.append((tl, jl))
    return steps, jcache, tcache


def _assert_caches_match(tcache, jcache):
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in tleaves] == \
        [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (_, a), (_, b) in zip(tleaves, jleaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(n(a), n(b), **MODEL_TOL)


@pytest.mark.parametrize("arch", TEXT)
def test_decode_8_steps_match_reference_and_own_prefill(arch):
    jcfg, tcfg, jp, tp = _smoke(arch)
    toks = _tokens(1, 8, jcfg.vocab_size)
    steps, jcache, tcache = _decode_both(jcfg, tcfg, jp, tp, toks, 16)
    for tl, jl in steps:
        np.testing.assert_allclose(n(tl), n(jl), **MODEL_TOL)
    _assert_caches_match(tcache, jcache)
    full, _ = Model(tcfg).apply(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(n(steps[-1][0][:, 0]), n(full[:, -1]),
                               **MODEL_TOL)


def test_qwen2_vl_decode_shapes_and_reference():
    """Qwen2-VL decodes text: ``pos`` on all three M-RoPE axes, as JAX
    does; shapes, cache structure and every step's logits agree, and the
    last step agrees with the port's prefill at text positions."""
    jcfg, tcfg, jp, tp = _smoke("qwen2-vl-72b")
    toks = _tokens(2, 8, jcfg.vocab_size)
    steps, jcache, tcache = _decode_both(jcfg, tcfg, jp, tp, toks, 16)
    for tl, jl in steps:
        assert tl.shape == (B, 1, jcfg.vocab_size)
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(n(tl), n(jl), **MODEL_TOL)
    _assert_caches_match(tcache, jcache)
    full, _ = Model(tcfg).apply(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(n(steps[-1][0][:, 0]), n(full[:, -1]),
                               **MODEL_TOL)


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-vl-72b"])
def test_global_cache_past_max_seq_matches_reference(arch):
    """12 steps into a 6-position global cache: the reference's scatter
    drops each write at pos >= max_seq and the step attends to the 6
    slots, so slot 0 keeps the first token's key (a ring buffer would
    overwrite it). Every step's logits and the final caches agree."""
    jcfg, tcfg, jp, tp = _smoke(arch)
    toks = _tokens(3, 12, jcfg.vocab_size)
    steps, jcache, tcache = _decode_both(jcfg, tcfg, jp, tp, toks, 6)
    for tl, jl in steps:
        np.testing.assert_allclose(n(tl), n(jl), **MODEL_TOL)
    _assert_caches_match(tcache, jcache)
    assert tcache[0]["b0"]["pos"].tolist() == [[12, 12], [12, 12]]
    # the cache holds the first 6 positions: a fresh 6-step decode
    _, _, first6 = _decode_both(jcfg, tcfg, jp, tp, toks[:, :6], 6)
    for key in ("k", "v"):
        torch.testing.assert_close(tcache[0]["b0"][key],
                                   first6[0]["b0"][key], rtol=0, atol=0)


@pytest.mark.parametrize("arch", GQA)
def test_prefill_step_tokens_match_reference(arch):
    jcfg, tcfg, jp, tp = _smoke(arch)
    batch = _batch(jcfg, 4, 48)
    want = jax.jit(jax_prefill(JModel(jcfg)))(jp, _to_jax(batch))
    got = make_prefill_step(Model(tcfg))(tp, _to_torch(batch))
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("arch", GQA)
def test_serve_step_tokens_match_reference(arch):
    jcfg, tcfg, jp, tp = _smoke(arch)
    jm, tm = JModel(jcfg), Model(tcfg)
    jstep, tstep = jax.jit(jax_serve(jm)), make_serve_step(tm)
    jcache = jm.init_cache(B, max_seq=32, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_seq=32, device="cpu", dtype=torch.float32)
    jt = jnp.asarray(_tokens(5, 1, jcfg.vocab_size), jnp.int32)
    tt = torch.from_numpy(np.array(jt))
    for _ in range(24):                   # feed each step its own output
        jt, jcache = jstep(jp, jcache, jt)
        tt, tcache = tstep(tp, tcache, tt)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
        np.testing.assert_array_equal(n(tt), n(jt))


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-vl-72b"])
def test_qk_norm_matches_reference(arch):
    """qk-norm (an RMSNorm of each head's q and k before RoPE, with the
    config's norm_eps) through ``dataclasses.replace(smoke, qk_norm=True)``:
    its two scales are leaves of the tree, and the logits and decode steps
    agree with the reference."""
    jcfg = dataclasses.replace(jax_arch(arch, smoke=True), qk_norm=True,
                               norm_eps=1e-5)
    tcfg = dataclasses.replace(get_arch(arch, smoke=True), qk_norm=True,
                               norm_eps=1e-5)
    jcfg, tcfg, jp, tp = _smoke(arch, jcfg, tcfg)
    attn = tp["stages"][0]["b0"]["attn"]
    assert attn["q_norm"]["scale"].shape == (2, tcfg.head_dim)
    # scales away from 1, so that a dropped norm would show
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 1.5 if "norm" in jax.tree_util.keystr(p) else x, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    batch = _batch(jcfg, 6, 32)
    want, _ = jax.jit(JModel(jcfg).apply)(jp, _to_jax(batch))
    got, _ = Model(tcfg).apply(tp, _to_torch(batch))
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)
    steps, jcache, tcache = _decode_both(jcfg, tcfg, jp, tp,
                                         _tokens(6, 6, jcfg.vocab_size), 8)
    for tl, jl in steps:
        np.testing.assert_allclose(n(tl), n(jl), **MODEL_TOL)
    _assert_caches_match(tcache, jcache)


@pytest.mark.parametrize("mlp_kind", ["swiglu", "squared_relu"])
def test_dense_kind_matches_reference(mlp_kind):
    """A ``dense`` block (deepseek's layer 0: attention with an MLP of
    width ``moe_dense_ff``) before an ``attn`` block: the MLP widths, the
    logits and the decode steps agree with the reference."""
    kw = dict(pattern=("dense", "attn"), moe_dense_ff=96, mlp_kind=mlp_kind)
    jcfg = dataclasses.replace(jax_arch("yi-9b", smoke=True), **kw)
    tcfg = dataclasses.replace(get_arch("yi-9b", smoke=True), **kw)
    assert tcfg.stages == jcfg.stages == ((("dense", "attn"), 1),)
    jcfg, tcfg, jp, tp = _smoke("yi-9b", jcfg, tcfg)
    unit = tp["stages"][0]
    assert unit["b0"]["mlp"]["w_up"].shape == (64, 96)
    assert unit["b1"]["mlp"]["w_up"].shape == (64, tcfg.d_ff)
    assert ("w_gate" in unit["b0"]["mlp"]) == (mlp_kind == "swiglu")
    batch = _batch(jcfg, 7, 40)
    want, _ = jax.jit(JModel(jcfg).apply)(jp, _to_jax(batch))
    got, _ = Model(tcfg).apply(tp, _to_torch(batch))
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)
    steps, jcache, tcache = _decode_both(jcfg, tcfg, jp, tp,
                                         _tokens(7, 6, jcfg.vocab_size), 8)
    for tl, jl in steps:
        np.testing.assert_allclose(n(tl), n(jl), **MODEL_TOL)
    _assert_caches_match(tcache, jcache)


@pytest.mark.parametrize("smoke_", [True, False])
@pytest.mark.parametrize("arch", GQA)
def test_params_from_jax_maps_every_leaf(arch, smoke_):
    """Every leaf of the JAX pytree maps onto the port's parameters with
    its shape. At full width (8.8 to 341 B parameters) nothing is
    materialised: the JAX shapes come from eval_shape, the leaves handed
    over are zero-stride views and land on ``meta``; the smoke trees are
    converted with their values."""
    jcfg, tcfg = jax_arch(arch, smoke=smoke_), get_arch(arch, smoke=smoke_)
    if smoke_:
        jp, npp = jax_params(jcfg, seed=0)
        tp = params_from_jax(npp, tcfg, device="cpu")
        for a, b in zip(jax.tree_util.tree_leaves(tp),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(n(a), np.asarray(b))
        shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    else:
        shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
        views = jax.tree_util.tree_map(
            lambda s: np.lib.stride_tricks.as_strided(
                np.zeros(1, np.float32), shape=s.shape,
                strides=(0,) * len(s.shape)), shapes)
        tp = params_from_jax(views, tcfg, device="meta")
        assert all(x.device.type == "meta"
                   for x in jax.tree_util.tree_leaves(tp))
    want = jax.tree_util.tree_leaves_with_path(shapes)
    got = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert [tuple(x.shape) for _, x in got] == [tuple(s.shape)
                                                for _, s in want]
    assert Model(tcfg).param_count() == JModel(jcfg).param_count()
    if not smoke_:
        assert Model(tcfg).param_count() == FULL_PARAMS[arch]


# --------------------------------------------------------------------------
# a mirror of tests/test_arch_smoke.py over every ported arch
# --------------------------------------------------------------------------

S = 32


def _smoke_batch(cfg):
    rng = np.random.default_rng(1)
    if cfg.frontend == "audio":
        batch = {"frames": rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S))}
    batch["labels"] = rng.integers(0, cfg.vocab_size, size=(B, S))
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(np.arange(S)[None, :], (B, S)).astype(np.int32)
        batch["positions"] = np.stack([pos, pos, pos])
        batch["vision_embeds"] = rng.standard_normal(
            (B, 4, cfg.d_model)).astype(np.float32)
    return _to_torch(batch)


@pytest.mark.parametrize("arch", all_archs())
def test_forward_and_grad_step(arch):
    cfg = get_arch(arch, smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _smoke_batch(cfg)
    logits, _ = model.apply(params, batch)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all(), "NaN/inf in logits"
    leafs = jax.tree_util.tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = model.loss(leafs, batch)
    # zeros for a leaf the loss does not read (hubert's embedding table),
    # as jax.grad gives them
    grads = torch.autograd.grad(loss, jax.tree_util.tree_leaves(leafs),
                                allow_unused=True, materialize_grads=True)
    assert torch.isfinite(loss)
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    assert torch.isfinite(gnorm) and float(gnorm) > 0
    with torch.no_grad():
        stepped = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [p - 1e-3 * g for p, g in zip(jax.tree_util.tree_leaves(params),
                                          grads)])
        loss2, _ = model.loss(stepped, batch)
    assert torch.isfinite(loss2)


@pytest.mark.parametrize("arch", [a for a in all_archs()
                                  if get_arch(a).decode_capable])
def test_decode_step_matches_prefill(arch):
    """Greedy decode consistency: S tokens through decode_step one at a
    time match the full-sequence forward. Unlike the reference's test
    this runs Qwen2-VL too: the port's prefill without positions rotates
    every M-RoPE axis by the text position, as its decode does."""
    cfg = get_arch(arch, smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(1, 8, cfg.vocab_size))
    full, _ = model.apply(params, {"tokens": toks})
    cache = model.init_cache(B, max_seq=16, device="cpu",
                             dtype=torch.float32)
    for i in range(8):
        logits, cache = model.decode_step(params, cache, toks[:, i:i + 1])
    np.testing.assert_allclose(n(logits[:, 0]), n(full[:, -1]),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", [a for a in all_archs()
                                  if get_arch(a).decode_capable])
def test_decode_step_shapes(arch):
    cfg = get_arch(arch, smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(B, max_seq=16, device="cpu",
                             dtype=torch.float32)
    structure = jax.tree_util.tree_structure(cache)
    logits, new_cache = model.decode_step(params, cache,
                                          torch.zeros(B, 1, dtype=torch.long))
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert jax.tree_util.tree_structure(new_cache) == structure


# --------------------------------------------------------------------------
# the Server
# --------------------------------------------------------------------------

def test_yi_9b_server_matches_jax_server_tokens():
    """The yi-9b smoke Server on the CPU answers 6 requests (4 then 2 in a
    batch) with the JAX Server's greedy tokens: its caches hold the
    batch's prompt + max_new = 20 positions, the JAX Server's 64, and
    neither decode passes 20."""
    mod = jax_serve_example()
    jrc.plan("threads", workers=8)
    jserver = mod.Server(arch="yi-9b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jserver.cfg.vocab_size, size=4).tolist()
               for _ in range(6)]
    want = serve_all(jserver, jrc, prompts)
    jrc.shutdown()

    rc.plan("threads", workers=8)
    np_params = jax.tree_util.tree_map(np.asarray, jserver.params)
    server = Server("yi-9b", device="cpu",
                    params=torch_params(np_params, jserver.cfg))
    got = serve_all(server, rc, prompts)
    assert got == want
    assert all(len(toks) == 16 for toks in got)
