"""The port's MLA family (minicpm3-4b) against the JAX package on the CPU.

Each test runs at three ``MLADims``: the smoke config's, a skewed one
where d_model, H, r_q, r_kv, dn, dr and dv all differ (the smoke dims have
dn == dv, which hides layout errors), and MiniCPM3's own; in fp32 within
``MODEL_TOL`` and in bf16 within 2e-2 of the largest value. At block level:
``mla_apply``'s prefill with and without positions, 8 absorbed decode steps
on fp32 and bf16 caches (every cache leaf), and writes past ``max_seq``.
At model level (the smoke config, 3 skewed layers, and one layer of
MiniCPM3's full width): logits, loss and every grad leaf, 8 decode steps
against JAX's and the port's own prefill, both step builders, the Server
token for token against the JAX Server, and ``params_from_jax`` bit for
bit; the full tree on ``meta`` with JAX's parameter count; and
``chip_smoke.mla_logits_fp64``, the card's fp64 reference."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import (MODEL_TOL, _reset_port, chip_smoke,  # noqa: E402,F401
                           decided, jax_greedy, jax_serve_example, n, randn,
                           serve_all)

import repro.core as jrc  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro.train import make_serve_step as jax_serve  # noqa: E402
import repro_torch.core as rc  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import _to_tensor, params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.serve import Server  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCH = "minicpm3-4b"
B = 2
#: the bf16 tolerance, relative to the largest value
TOL_BF16 = 2e-2
DTYPES = ["float32", "bfloat16"]
#: JAX's Model.param_count of the full config (fp32 leaves)
FULL_PARAMS = 4_261_902_848

#: MLADims fields: the smoke config's, a skewed set, MiniCPM3's
DIMS = {
    "smoke": dataclasses.asdict(jax_arch(ARCH, smoke=True).mla),
    "skewed": dict(d_model=48, n_heads=3, q_lora_rank=20, kv_lora_rank=12,
                   qk_nope_dim=6, qk_rope_dim=10, v_head_dim=5),
    "full": dataclasses.asdict(jax_arch(ARCH).mla),
}
ROPE_THETA = 1e4


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float()
    return n(x).astype(np.float32)


def _close(got, want, dtype: str, full: bool = False) -> None:
    """fp32 within ``MODEL_TOL``; with ``full`` (logits of the full-width
    model, each a sum of 2560 products, reaching ~185) its atol is taken
    relative to the largest value, as the card's fp32 limit is. bf16
    within ``TOL_BF16`` of the largest value."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        scale = max(1.0, float(np.abs(want).max())) if full else 1.0
        np.testing.assert_allclose(got, want, rtol=MODEL_TOL["rtol"],
                                   atol=MODEL_TOL["atol"] * scale)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= TOL_BF16 * scale, \
            (np.abs(got - want).max(), scale)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke_", [False, True])
def test_configs_match_reference(smoke_):
    j, t_ = jax_arch(ARCH, smoke=smoke_), get_arch(ARCH, smoke=smoke_)
    assert t_.stages == j.stages
    assert t_.layer_pattern == j.layer_pattern == ("mla",) * j.n_layers
    assert isinstance(t_.mla, TMLA.MLADims)
    assert dataclasses.asdict(t_.mla) == dataclasses.asdict(j.mla)
    for f in dataclasses.fields(j):
        if f.name != "mla":
            assert getattr(t_, f.name) == getattr(j, f.name), f.name


def test_mla_dims_defaults_and_cache_width():
    """The dataclass's defaults are the reference's, and a cache holds
    r_kv + dr values a token a layer: 288 at MiniCPM3's dims."""
    assert dataclasses.asdict(TMLA.MLADims(8, 2)) == \
        dataclasses.asdict(JMLA.MLADims(8, 2))
    full = TMLA.MLADims(**DIMS["full"])
    cache = TMLA.mla_cache_init(3, 5, full, torch.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "c_kv": (3, 5, 256), "k_rope": (3, 5, 1, 32), "pos": (3,)}
    assert cache["pos"].dtype == torch.int32
    assert sum(v[0, 0].numel() for k, v in cache.items() if k != "pos") \
        == 288
    assert all(v.dtype == torch.bfloat16 for k, v in
               TMLA.mla_cache_init(1, 2, full).items() if k != "pos")


# --------------------------------------------------------------------------
# one MLA block
# --------------------------------------------------------------------------

_BLOCKS: dict = {}


def _block(name: str, dtype: str):
    """(jax dims, torch dims, jax params, torch params) of one block drawn
    by the reference's ``mla_init`` in ``dtype``, its two norm scales moved
    away from 1 so that a dropped norm would show."""
    if (name, dtype) not in _BLOCKS:
        jd, td = JMLA.MLADims(**DIMS[name]), TMLA.MLADims(**DIMS[name])
        jp = JMLA.mla_init(jax.random.PRNGKey(0), jd, getattr(jnp, dtype))
        rng = np.random.default_rng(1)
        for key in ("q_a_norm", "kv_a_norm"):
            scale = jp[key]["scale"]
            jp[key]["scale"] = jnp.asarray(
                1 + 0.5 * rng.standard_normal(scale.shape), scale.dtype)
        tp = tree_map(_to_tensor, jax.tree_util.tree_map(np.asarray, jp))
        _BLOCKS[name, dtype] = (jd, td, jp, tp)
    return _BLOCKS[name, dtype]


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _positions(rng, s: int) -> np.ndarray:
    """Increasing positions up to ~4000 with gaps, another run a row."""
    return np.stack([np.sort(rng.choice(4096, s, replace=False))
                     for _ in range(B)]).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_positions", [False, True])
@pytest.mark.parametrize("name", sorted(DIMS))
def test_mla_prefill_matches_reference(name, with_positions, dtype):
    jd, td, jp, tp = _block(name, dtype)
    rng = np.random.default_rng(2)
    s = 16 if name == "full" else 24
    jx, tx = _both(randn(rng, B, s, jd.d_model), dtype)
    kw = dict(rope_theta=ROPE_THETA, norm_eps=1e-6)
    pos = _positions(rng, s) if with_positions else None
    want, wc = JMLA.mla_apply(
        jp, jx, jd, positions=None if pos is None else jnp.asarray(pos),
        **kw)
    got, tc = TMLA.mla_apply(
        tp, tx, td, positions=None if pos is None else torch.from_numpy(pos),
        **kw)
    assert wc is None and tc is None
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    if with_positions:                  # the positions are used
        plain, _ = TMLA.mla_apply(tp, tx, td, **kw)
        assert (plain - got).abs().max() > 1e-2


def _block_decode(name, dtype, cache_dtype, steps, max_seq, start, seed=3):
    """``steps`` absorbed decode steps of both packages from caches of
    ``max_seq`` slots filled with the same random latents, row i starting
    at position ``start[i]``: each step's outputs and both final caches,
    and the port's cache after each step (clones)."""
    jd, td, jp, tp = _block(name, dtype)
    rng = np.random.default_rng(seed)
    jc = JMLA.mla_cache_init(B, max_seq, jd, getattr(jnp, cache_dtype))
    tc = TMLA.mla_cache_init(B, max_seq, td, getattr(torch, cache_dtype))
    for key in ("c_kv", "k_rope"):
        jc[key], tc[key] = _both(randn(rng, *jc[key].shape), cache_dtype)
    jc["pos"] = jnp.asarray(start, jnp.int32)
    tc["pos"] = torch.tensor(start, dtype=torch.int32)
    kw = dict(rope_theta=ROPE_THETA, norm_eps=1e-6)
    apply = jax.jit(lambda p, x, c: JMLA.mla_apply(p, x, jd, cache=c, **kw))
    outs, history = [], []
    for _ in range(steps):
        jx, tx = _both(randn(rng, B, 1, jd.d_model), dtype)
        want, jc = apply(jp, jx, jc)
        got, tc = TMLA.mla_apply(tp, tx, td, cache=tc, **kw)
        outs.append((got, want))
        history.append(tree_map(torch.clone, tc))
    return outs, tc, jc, history


@pytest.mark.parametrize("cache_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(DIMS))
def test_mla_absorbed_decode_matches_reference(name, dtype, cache_dtype):
    """8 absorbed decode steps with rows at different positions: every
    step's output and every cache leaf; the latents are written in place
    in the cache's type."""
    outs, tc, jc, _ = _block_decode(name, dtype, cache_dtype, 8, 16, [0, 5])
    for got, want in outs:
        assert got.dtype == getattr(torch, dtype) and got.shape[1] == 1
        _close(got, want, dtype)
    assert sorted(tc) == sorted(jc) == ["c_kv", "k_rope", "pos"]
    for key in ("c_kv", "k_rope"):
        assert tc[key].dtype == getattr(torch, cache_dtype)
        _close(tc[key], jc[key], "float32" if dtype == cache_dtype ==
               "float32" else "bfloat16")
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [8, 13]


@pytest.mark.parametrize("cache_dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(DIMS))
def test_mla_write_past_max_seq_matches_reference(name, cache_dtype):
    """10 steps into 6 slots, rows starting at 0 and 3: the reference's
    scatter drops each write at pos >= max_seq, and a step then attends to
    all 6 slots. Every output and cache leaf agrees, and the final cache is
    the one after step 6 bit for bit, the last step whose writes fit (a
    ring buffer would overwrite slot 0)."""
    outs, tc, jc, history = _block_decode(name, "float32", cache_dtype, 10,
                                          6, [0, 3])
    for got, want in outs:
        _close(got, want, "float32")
    for key in ("c_kv", "k_rope"):
        _close(tc[key], jc[key], "float32" if cache_dtype == "float32"
               else "bfloat16")
        assert torch.equal(tc[key], history[5][key])
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [10, 13]


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _cfgs(name: str):
    """(jax cfg, torch cfg): the smoke config, 3 skewed layers (stacked
    for the scan), or one layer of MiniCPM3 at full width with a vocab of
    256."""
    if name == "smoke":
        return jax_arch(ARCH, smoke=True), get_arch(ARCH, smoke=True)
    if name == "skewed":
        kw = dict(n_layers=3, d_model=48, n_heads=3, n_kv_heads=3, d_ff=80,
                  vocab_size=96, rope_theta=ROPE_THETA, norm_eps=1e-5)
        j, t_ = jax_arch(ARCH, smoke=True), get_arch(ARCH, smoke=True)
    else:
        kw = dict(n_layers=1, vocab_size=256)
        j, t_ = jax_arch(ARCH), get_arch(ARCH)
    return (dataclasses.replace(j, mla=JMLA.MLADims(**DIMS[name]), **kw),
            dataclasses.replace(t_, mla=TMLA.MLADims(**DIMS[name]), **kw))


_MODELS: dict = {}


def _model(name: str, dtype: str = "float32"):
    """(jax cfg, torch cfg, jax params, torch params), built once each."""
    if (name, dtype) not in _MODELS:
        jcfg, tcfg = _cfgs(name)
        jp = JModel(jcfg).init(jax.random.PRNGKey(0), getattr(jnp, dtype))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             device="cpu")
        _MODELS[name, dtype] = (jcfg, tcfg, jp, tp)
    return _MODELS[name, dtype]


def _seq(name: str) -> int:
    return 16 if name == "full" else 32


def _tokens(seed, s, vocab, b=B):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_positions", [False, True])
@pytest.mark.parametrize("name", sorted(DIMS))
def test_apply_logits_match_reference(name, with_positions, dtype):
    jcfg, tcfg, jp, tp = _model(name, dtype)
    s = _seq(name)
    batch = {"tokens": _tokens(4, s, jcfg.vocab_size)}
    if with_positions:
        batch["positions"] = _positions(np.random.default_rng(4), s)
    want, _ = jax.jit(JModel(jcfg).apply)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = Model(tcfg).apply(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (B, s,
                                                        jcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want, dtype, full=name == "full")


def _one_ulp_moved(jp):
    """A JAX tree with its bf16 embedding table stepped to the next bf16
    value (its int16 view plus one), as ``chip_smoke.one_ulp_moved``."""
    table = np.asarray(jp["embed"]["table"])
    moved = (table.view(np.int16) + 1).view(table.dtype)
    return dict(jp, embed={"table": jnp.asarray(moved)})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(DIMS))
def test_loss_and_grads_match_reference(name, dtype):
    """``Model.loss`` and every grad leaf against ``jax.value_and_grad``.
    In fp32 each leaf within 1e-4 of its largest JAX grad. In bf16 the
    loss within TOL_BF16, and each leaf within twice the 1-ulp yardstick
    of the same leaf: how far JAX's own bf16 grads move when the embedding
    table moves by one bf16 ulp (1.5% to 17% of a leaf's largest grad at
    these sizes, so rounding alone carries bf16 grads past a fixed 2e-2;
    the port sat at up to 1.25 yardsticks when this was set)."""
    jcfg, tcfg, jp, tp = _model(name, dtype)
    rng = np.random.default_rng(5)
    s = _seq(name)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(B, s)),
             "labels": rng.integers(0, jcfg.vocab_size, size=(B, s))}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.value_and_grad(JModel(jcfg).loss, has_aux=True))
    (jloss, _), jg = grad(jp, jbatch)
    (loss, _), grads = value_and_grad(
        Model(tcfg), tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = 1e-4 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol)
    want = jax.tree_util.tree_leaves_with_path(jg)
    got = jax.tree_util.tree_leaves_with_path(grads)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert any("wkv_b" in jax.tree_util.keystr(p) for p, _ in want)
    if dtype == "float32":
        limits = [tol * max(float(np.abs(_f32(w)).max()), 1e-30)
                  for _, w in want]
    else:
        _, yard = grad(_one_ulp_moved(jp), jbatch)
        limits = [2 * float(np.abs(_f32(m) - _f32(w)).max())
                  for m, (_, w) in zip(jax.tree_util.tree_leaves(yard),
                                       want)]
    for (path, g), (_, w), limit in zip(got, want, limits):
        err = float(np.abs(_f32(g) - _f32(w)).max())
        assert 0 < limit and err <= limit, \
            (jax.tree_util.keystr(path), err, limit)


@pytest.mark.parametrize("cache_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(DIMS))
def test_decode_8_steps_match_reference_and_own_prefill(name, dtype,
                                                        cache_dtype):
    """Every step's logits of ``decode_step`` against JAX's, the final
    caches leaf by leaf (a stacked stage's updated in its stacked
    tensors), and the last step against the port's own prefill."""
    jcfg, tcfg, jp, tp = _model(name, dtype)
    jm, tm = JModel(jcfg), Model(tcfg)
    jcache = jm.init_cache(B, max_seq=16, dtype=getattr(jnp, cache_dtype))
    tcache = tm.init_cache(B, max_seq=16, device="cpu",
                           dtype=getattr(torch, cache_dtype))
    step = jax.jit(jm.decode_step)
    toks = _tokens(6, 8, jcfg.vocab_size)
    # a bf16 cache rounds the latents, so fp32 parameters on it are held
    # at the bf16 tolerance
    wide = "float32" if dtype == cache_dtype == "float32" else "bfloat16"
    for i in range(8):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]))
        assert tl.shape == (B, 1, jcfg.vocab_size)
        _close(tl, jl, wide, full=name == "full")
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in tleaves] == \
        [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (p, a), (_, b) in zip(tleaves, jleaves):
        if jax.tree_util.keystr(p).endswith("['pos']"):
            np.testing.assert_array_equal(n(a), np.asarray(b))
        else:
            assert a.dtype == getattr(torch, cache_dtype)
            _close(a, b, wide)
    full, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl[:, 0], full[:, -1], wide, full=name == "full")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(DIMS))
def test_prefill_step_tokens_match_reference(name, dtype):
    """The greedy token after the prompt; in bf16 where the reference's
    top-2 margin exceeds the tolerance."""
    jcfg, tcfg, jp, tp = _model(name, dtype)
    toks = _tokens(7, _seq(name), jcfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks)}
    want = jax.jit(jax_prefill(JModel(jcfg)))(jp, batch)
    got = make_prefill_step(Model(tcfg))(tp,
                                         {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    if dtype == "float32":
        np.testing.assert_array_equal(n(got), n(want))
        return
    logits, _ = jax.jit(JModel(jcfg).apply)(jp, batch)
    sure = decided(logits[:, -1], TOL_BF16)
    assert sure.any()
    np.testing.assert_array_equal(n(got)[sure, 0], n(want)[sure, 0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(DIMS))
def test_serve_step_tokens_match_reference(name, dtype):
    """16 greedy steps on fp32 caches, both packages fed the reference's
    tokens; in bf16 compared where the reference's top-2 margin exceeds
    the tolerance."""
    jcfg, tcfg, jp, tp = _model(name, dtype)
    jm, tm = JModel(jcfg), Model(tcfg)
    jstep, tstep = jax.jit(jax_serve(jm)), make_serve_step(tm)
    jdecode = jax.jit(jm.decode_step)
    jcache, lcache = (jm.init_cache(B, max_seq=32, dtype=jnp.float32)
                      for _ in range(2))
    tcache = tm.init_cache(B, max_seq=32, device="cpu", dtype=torch.float32)
    jt = jnp.asarray(_tokens(8, 1, jcfg.vocab_size), jnp.int32)
    held = 0
    for _ in range(16):
        tt, tcache = tstep(tp, tcache, torch.from_numpy(np.array(jt)))
        logits, lcache = jdecode(jp, lcache, jt)
        jt, jcache = jstep(jp, jcache, jt)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
        sure = (np.ones(B, bool) if dtype == "float32"
                else decided(logits[:, -1], TOL_BF16))
        np.testing.assert_array_equal(n(tt)[sure, 0], n(jt)[sure, 0])
        held += int(sure.sum())
    assert held >= (2 * 16 if dtype == "float32" else 4)


def _servers(name, jcfg, tcfg, jp, tp):
    """The JAX example's Server and the port's, both serving ``jcfg`` /
    ``tcfg`` from the same parameters."""
    jserver = jax_serve_example().Server(arch=ARCH)
    jserver.cfg, jserver.model, jserver.params = jcfg, JModel(jcfg), jp
    jserver.step = jax.jit(jax_serve(jserver.model))
    server = Server(ARCH, device="cpu", params=tp)
    if name != "smoke":
        server.cfg, server.model = tcfg, Model(tcfg)
        server.step = make_serve_step(server.model)
    return jserver, server


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(DIMS))
def test_server_matches_jax_server_tokens(name, dtype):
    """The Server on the CPU answers 6 requests (4 then 2 in a batch) with
    the JAX Server's greedy tokens: in fp32 all of them; in bf16 up to
    each request's first token whose top-2 margin in the reference is
    within the tolerance, where greedy decoding of a bf16 model may go
    either way and every later token follows that choice. The port's
    caches hold prompt + max_new = 20 positions, the JAX Server's 64."""
    jcfg, tcfg, jp, tp = _model(name, dtype)
    jserver, server = _servers(name, jcfg, tcfg, jp, tp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=4).tolist()
               for _ in range(6)]
    jrc.plan("threads", workers=8)
    want = serve_all(jserver, jrc, prompts)
    jrc.shutdown()
    rc.plan("threads", workers=8)
    got = serve_all(server, rc, prompts)
    assert all(len(toks) == 16 for toks in got)
    if dtype == "float32":
        assert got == want
        return
    first, second = (jax_greedy(jcfg, jp, batch, TOL_BF16)
                     for batch in (prompts[:4], prompts[4:]))
    ref_toks, sure = first[0] + second[0], first[1] + second[1]
    held = 0
    for g_, w_, r_, d_ in zip(got, want, ref_toks, sure):
        k = d_.index(False) if False in d_ else len(d_)
        assert g_[:k] == w_[:k] == r_[:k]
        held += k
    assert held >= 6, held


# --------------------------------------------------------------------------
# parameter conversion
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(DIMS))
def test_params_from_jax_bit_for_bit(name, dtype):
    """Every leaf of the JAX tree lands on the port's path with its shape,
    type and bits, and the port's own tree has the same paths and
    shapes."""
    jcfg, tcfg, jp, tp = _model(name, dtype)
    want = jax.tree_util.tree_leaves_with_path(jp)
    got = jax.tree_util.tree_leaves_with_path(tp)
    own = jax.tree_util.tree_leaves_with_path(
        Model(tcfg).init(torch.Generator(), device="meta"))
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want] == \
        [jax.tree_util.keystr(p) for p, _ in own]
    for (_, a), (_, b), (_, c) in zip(got, want, own):
        assert a.dtype == getattr(torch, dtype)
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape)
        assert torch.equal(a, _to_tensor(np.asarray(b)))
    assert Model(tcfg).param_count() == JModel(jcfg).param_count()


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_tree_converts_on_meta(dtype):
    """MiniCPM3-4B's full tree (4.26 B parameters, 17.0 GB in fp32):
    JAX's shapes from eval_shape, handed over as zero-stride views, land
    on ``meta`` path for path, and both packages count the same
    parameters."""
    jcfg, tcfg = jax_arch(ARCH), get_arch(ARCH)
    shapes = jax.eval_shape(lambda k: JModel(jcfg).init(
        k, getattr(jnp, dtype)), jax.random.PRNGKey(0))
    np_dtype = np.float32 if dtype == "float32" else jnp.bfloat16
    views = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np_dtype), shape=s.shape,
            strides=(0,) * len(s.shape)), shapes)
    tp = params_from_jax(views, tcfg, device="meta")
    want = jax.tree_util.tree_leaves_with_path(shapes)
    got = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert [tuple(x.shape) for _, x in got] == [tuple(s.shape)
                                                for _, s in want]
    assert all(x.device.type == "meta" and x.dtype == getattr(torch, dtype)
               for _, x in got)
    assert sum(x.numel() for _, x in got) == FULL_PARAMS
    assert Model(tcfg).param_count() == JModel(jcfg).param_count() == \
        FULL_PARAMS


# --------------------------------------------------------------------------
# chip_smoke.py's fp64 reference (phase 3g)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DIMS))
def test_chip_smoke_fp64_reference_matches_port_and_jax(name):
    """``mla_logits_fp64``, the card's reference for the fp32 prefill,
    agrees with the port's and JAX's fp32 logits within ``MODEL_TOL``,
    and moves when the RoPE turns at another rate."""
    jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(9, _seq(name), jcfg.vocab_size)
    ref = chip_smoke().mla_logits_fp64(tcfg, tp, torch.from_numpy(toks))
    assert ref.dtype == torch.float64
    got, _ = Model(tcfg).apply(tp, {"tokens": torch.from_numpy(toks)})
    want, _ = jax.jit(JModel(jcfg).apply)(jp, {"tokens": jnp.asarray(toks)})
    _close(ref, got, "float32")
    _close(ref, want, "float32")
    other = dataclasses.replace(tcfg, rope_theta=1e2)
    moved = chip_smoke().mla_logits_fp64(other, tp, torch.from_numpy(toks))
    assert (moved - ref).abs().max() > 1e-2
