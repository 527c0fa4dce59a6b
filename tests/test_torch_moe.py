"""The port's MoE family (qwen2-moe-a2.7b, deepseek-moe-16b) against
``repro.models`` on parameters copied by ``params_from_jax``: ``MoEDims``
and the configs, ``moe_apply`` (routing first, then the output and the aux
loss) at the smoke dims and at the published expert counts with a capacity
that drops tokens, per-row capacity, the pad experts, the model's logits,
aux, loss and grads, decode, the step builders, the parameter conversion of
the full trees on ``meta`` and of a bf16 tree, and the qwen2-moe Server.

Tolerances: one ``moe_apply`` within 1e-5 (rtol and atol; XLA and ATen sum
its products in other orders, ~1e-7 here), its aux within 1e-6 relative;
the model's logits and decode steps within ``MODEL_TOL`` (1e-4), the loss
within 1e-5 relative and each grad leaf within 1e-4 of that leaf's largest
JAX grad, as ``test_torch_train.py`` holds them. Routing is compared exactly
before any value, so a top-k flip shows as a routing mismatch, not as a
stray error in y."""

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
from repro.models import moe as JMOE  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
import repro_torch.core as rc  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.serve import Server  # noqa: E402
from repro_torch.train import make_prefill_step  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import map_with_path  # noqa: E402

MOE = ["qwen2-moe-a2.7b", "deepseek-moe-16b"]
B = 2
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
# JAX's Model.param_count of each full config (fp32 leaves; qwen2-moe's
# experts padded 60 -> 64)
FULL_PARAMS = {"qwen2-moe-a2.7b": 15_146_059_776,
               "deepseek-moe-16b": 16_375_728_128}

# (d_model, n_experts, top_k, d_expert, n_shared, capacity_factor,
#  n_experts_padded): both smoke dims (their own factor 4.0, which never
# binds, and 0.5, which drops half), and the published expert counts at
# narrow width with the published factor 1.25
DIMS = {
    "qwen-smoke": (64, 8, 2, 32, 2, 4.0, 0),
    "deepseek-smoke": (64, 8, 3, 32, 1, 4.0, 0),
    "qwen-smoke-0.5": (64, 8, 2, 32, 2, 0.5, 0),
    "deepseek-smoke-0.5": (64, 8, 3, 32, 1, 0.5, 0),
    "qwen-published": (64, 60, 4, 32, 4, 1.25, 64),
    "deepseek-published": (64, 64, 6, 32, 2, 1.25, 0),
}
S_MOE = 64


def _dims(name):
    d, e, k, f, ns, cf, ep = DIMS[name]
    kw = dict(d_model=d, n_experts=e, top_k=k, d_expert=f, n_shared=ns,
              capacity_factor=cf, n_experts_padded=ep)
    return JMOE.MoEDims(**kw), TMOE.MoEDims(**kw)


def _moe_params(jdims, seed):
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), jdims)
    return jp, jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jp)


def _x(seed, b=B, s=S_MOE, d=64):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _jax_routing(p, x, dims):
    """The reference's decisions (``repro/models/moe.py:72-93``, which
    ``moe_apply`` keeps to itself): top-k indices and the within-capacity
    mask."""
    b, s, _ = x.shape
    e, k = dims.n_experts, dims.top_k
    cap = max(1, int(dims.capacity_factor * s * k / e))
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), -1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    cnt = jnp.cumsum(onehot.reshape(b, s * k, e), axis=1).reshape(b, s, k, e)
    pos = jnp.sum(cnt * onehot, axis=-1) - 1
    return np.asarray(idx), np.asarray(pos < cap), cap


# --------------------------------------------------------------------------
# dims and configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DIMS))
def test_moe_dims_match_reference(name):
    j, t_ = _dims(name)
    assert dataclasses.asdict(t_) == dataclasses.asdict(j)
    assert t_.e_pad == j.e_pad
    for s in (1, 7, 64, 512, 4096):
        assert TMOE.capacity(t_, s) == max(
            1, int(j.capacity_factor * s * j.top_k / j.n_experts))


@pytest.mark.parametrize("smoke_", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_configs_match_reference(arch, smoke_):
    j, t_ = jax_arch(arch, smoke=smoke_), get_arch(arch, smoke=smoke_)
    assert t_.stages == j.stages
    assert t_.layer_pattern == j.layer_pattern
    assert isinstance(t_.moe, TMOE.MoEDims)
    assert dataclasses.asdict(t_.moe) == dataclasses.asdict(j.moe)
    for f in dataclasses.fields(j):
        if f.name not in ("moe", "mla", "rglru", "xlstm"):
            assert getattr(t_, f.name) == getattr(j, f.name), f.name
    assert (t_.mla, t_.rglru, t_.xlstm) == (None, None, None)


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DIMS))
def test_moe_apply_matches_reference(name):
    """Equal top-k indices (in their order) and equal drop masks first,
    then y and aux. Below the smoke factor 4.0 the capacity binds at B=2,
    S=64, and some assignments drop."""
    jdims, tdims = _dims(name)
    jp, tp = _moe_params(jdims, 3)
    x = _x(4)
    idx, within, cap = _jax_routing(jp, jnp.asarray(x), jdims)
    r = TMOE.route(tp["router"], torch.from_numpy(x), tdims)
    assert r.capacity == cap
    np.testing.assert_array_equal(n(r.gate_idx), idx)
    np.testing.assert_array_equal(n(r.within), within)
    if tdims.capacity_factor < 4.0:
        assert not within.all(), "the capacity must bind"
    else:
        assert within.all()
    want, want_aux = JMOE.moe_apply(jp, jnp.asarray(x), jdims)
    got, aux = TMOE.moe_apply(tp, torch.from_numpy(x), tdims)
    assert got.shape == (B, S_MOE, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert float(aux) > 0


def test_capacity_is_per_batch_row():
    """Each batch row has its own capacity: permuting the rows permutes
    the output and changes nothing else, and a row alone gives what it
    gives in the batch, with the capacity binding."""
    jdims, tdims = _dims("qwen-published")
    _, tp = _moe_params(jdims, 5)
    x = torch.from_numpy(_x(6, b=4))
    r = TMOE.route(tp["router"], x, tdims)
    assert not r.within.all()
    y, _ = TMOE.moe_apply(tp, x, tdims)
    perm = torch.tensor([2, 0, 3, 1])
    y_perm, _ = TMOE.moe_apply(tp, x[perm], tdims)
    torch.testing.assert_close(y_perm, y[perm], rtol=1e-6, atol=1e-6)
    for row in range(4):
        alone, _ = TMOE.moe_apply(tp, x[row:row + 1], tdims)
        torch.testing.assert_close(alone[0], y[row], rtol=1e-6, atol=1e-6)


def test_pad_experts_are_never_routed_and_get_no_grad():
    """qwen2-moe's 60 routed experts padded to 64: no assignment names a
    pad expert, and their weights' grads are exactly zero while every real
    expert's gate weights get some."""
    jdims, tdims = _dims("qwen-published")
    _, tp = _moe_params(jdims, 7)
    tp = {k: (v.requires_grad_(True) if isinstance(v, torch.Tensor) else v)
          for k, v in tp.items()}
    x = torch.from_numpy(_x(8, b=4))
    r = TMOE.route(tp["router"], x, tdims)
    assert int(r.gate_idx.max()) < tdims.n_experts < tdims.e_pad
    y, aux = TMOE.moe_apply(tp, x, tdims)
    names = ("router", "w_gate", "w_up", "w_down")
    grads = dict(zip(names, torch.autograd.grad(
        (y ** 2).sum() + aux, [tp[k] for k in names])))
    assert grads["router"].shape == (64, 60)
    for key in ("w_gate", "w_up", "w_down"):
        assert torch.all(grads[key][60:] == 0), key
    routed = torch.unique(r.gate_idx[r.within])
    assert len(routed) == 60
    assert torch.all(grads["w_gate"][routed].abs().amax((1, 2)) > 0)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

_SMOKE: dict = {}


def _smoke(arch):
    """(jax cfg, torch cfg, jax params, torch params), built once."""
    if arch not in _SMOKE:
        jcfg, tcfg = jax_arch(arch, smoke=True), get_arch(arch, smoke=True)
        jp, npp = jax_params(jcfg, seed=0)
        _SMOKE[arch] = (jcfg, tcfg, jp, torch_params(npp, tcfg))
    return _SMOKE[arch]


def _tokens(seed, s, vocab, b=B):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


@pytest.mark.parametrize("s", [32, 96])
@pytest.mark.parametrize("arch", MOE)
def test_apply_logits_and_aux_match_reference(arch, s):
    """The aux loss summed over every stage and repeat (qwen2-moe: a
    stacked stage of 2; deepseek-moe: one unrolled unit of dense, moe,
    moe) and the logits."""
    jcfg, tcfg, jp, tp = _smoke(arch)
    toks = _tokens(s, s, jcfg.vocab_size)
    want, want_aux = jax.jit(JModel(jcfg).apply)(
        jp, {"tokens": jnp.asarray(toks)})
    got, aux = Model(tcfg).apply(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, s, jcfg.vocab_size)
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def _leaves(tree) -> dict:
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(path, n(leaf)), tree)
    return out


def _jax_leaves(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,remat", [("qwen2-moe-a2.7b", "none"),
                                        ("qwen2-moe-a2.7b", "full"),
                                        ("deepseek-moe-16b", "none")])
def test_loss_and_grads_match_reference(arch, remat):
    """``Model.loss`` is ce + aux with a nonzero aux; every grad leaf, the
    routers included, against ``jax.value_and_grad``."""
    jcfg, tcfg, jp, tp = _smoke(arch)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(B, 48)),
             "labels": rng.integers(0, jcfg.vocab_size, size=(B, 48))}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        JModel(jcfg).loss, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, metrics), grads = value_and_grad(
        Model(tcfg, remat=remat), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(metrics["aux"]) > 0
    for got, want in ((loss, jloss), (metrics["ce"], jm["ce"]),
                      (metrics["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want = _jax_leaves(jg)
    got = _leaves(grads)
    assert sorted(got) == sorted(want)
    assert any(k.endswith("moe/router") for k in want)
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-30)
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= 1e-4 * scale, (key, err, scale)


@pytest.mark.parametrize("arch", MOE)
def test_decode_8_steps_match_reference_and_own_prefill(arch):
    """Every decode step's logits against the reference's and the caches;
    the last step against the port's prefill (the smoke capacity factor
    4.0 never drops, so the two paths compute the same function)."""
    jcfg, tcfg, jp, tp = _smoke(arch)
    toks = _tokens(1, 8, jcfg.vocab_size)
    jm, tm = JModel(jcfg), Model(tcfg)
    jcache = jm.init_cache(B, max_seq=16, dtype=jnp.float32)
    tcache = tm.init_cache(B, max_seq=16, device="cpu", dtype=torch.float32)
    step = jax.jit(jm.decode_step)
    for i in range(8):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(n(tl), n(jl), **MODEL_TOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in tleaves] == \
        [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (_, a), (_, b) in zip(tleaves, jleaves):
        np.testing.assert_allclose(n(a), n(b), **MODEL_TOL)
    full, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(n(tl[:, 0]), n(full[:, -1]), **MODEL_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_step_tokens_match_reference(arch):
    jcfg, tcfg, jp, tp = _smoke(arch)
    toks = _tokens(4, 48, jcfg.vocab_size)
    want = jax.jit(jax_prefill(JModel(jcfg)))(jp, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(Model(tcfg))(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    np.testing.assert_array_equal(n(got), n(want))


def test_model_drops_tokens_as_the_reference_does(monkeypatch):
    """qwen2-moe's smoke model with the full config's capacity factor
    (1.25, which binds at S=64): the model's routing drops assignments,
    and the logits and aux still agree with the reference."""
    jcfg = dataclasses.replace(
        jax_arch("qwen2-moe-a2.7b", smoke=True),
        moe=dataclasses.replace(jax_arch("qwen2-moe-a2.7b", smoke=True).moe,
                                capacity_factor=1.25))
    tcfg = dataclasses.replace(
        get_arch("qwen2-moe-a2.7b", smoke=True),
        moe=dataclasses.replace(get_arch("qwen2-moe-a2.7b", smoke=True).moe,
                                capacity_factor=1.25))
    jp, npp = jax_params(jcfg, seed=2)
    tp = torch_params(npp, tcfg)
    toks = _tokens(5, 64, jcfg.vocab_size)
    dropped = []
    route = TMOE.route

    def recording(router, x, dims):
        r = route(router, x, dims)
        dropped.append(int((~r.within).sum()))
        return r

    monkeypatch.setattr(TMOE, "route", recording)
    got, aux = Model(tcfg).apply(tp, {"tokens": torch.from_numpy(toks)})
    assert len(dropped) == 2 and sum(dropped) > 0
    want, want_aux = jax.jit(JModel(jcfg).apply)(
        jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(n(got), n(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


# --------------------------------------------------------------------------
# parameter conversion
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke_", [True, False])
@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_maps_every_leaf(arch, smoke_):
    """Every leaf of the JAX pytree, the routers and expert stacks
    included, maps onto the port's parameters with its shape and no
    special case. At full width (15.1 and 16.4 B parameters) the JAX
    shapes come from eval_shape and the leaves land on ``meta``."""
    jcfg, tcfg = jax_arch(arch, smoke=smoke_), get_arch(arch, smoke=smoke_)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    if smoke_:
        jp, npp = jax_params(jcfg, seed=0)
        tp = params_from_jax(npp, tcfg, device="cpu")
        for a, b in zip(jax.tree_util.tree_leaves(tp),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(n(a), np.asarray(b))
    else:
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


def test_params_from_jax_converts_bf16_bit_for_bit():
    """A ``Model.init(key, bfloat16)`` tree (numpy views of dtype
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) converts
    to bf16 tensors with the same bits; the fp32 routers stay fp32."""
    jcfg = jax_arch("qwen2-moe-a2.7b", smoke=True)
    tcfg = get_arch("qwen2-moe-a2.7b", smoke=True)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0), jnp.bfloat16)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_jax(npp, tcfg, device="cpu")
    pairs = list(zip(jax.tree_util.tree_leaves(tp),
                     jax.tree_util.tree_leaves(npp)))
    assert {str(a.dtype) for a, _ in pairs} == {"torch.bfloat16",
                                                "torch.float32"}
    for a, b in pairs:
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy().view(np.uint16),
                b.view(np.uint16))
        else:
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b)
    assert tp["stages"][0]["b0"]["moe"]["router"].dtype == torch.float32


# --------------------------------------------------------------------------
# the Server
# --------------------------------------------------------------------------

def test_qwen2_moe_server_matches_jax_server_tokens():
    """The qwen2-moe smoke Server on the CPU answers 6 requests (4 then 2
    in a batch) with the JAX Server's greedy tokens. It prefills by
    single-token decode steps, so no capacity ever binds."""
    mod = jax_serve_example()
    jrc.plan("threads", workers=8)
    jserver = mod.Server(arch="qwen2-moe-a2.7b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jserver.cfg.vocab_size, size=4).tolist()
               for _ in range(6)]
    want = serve_all(jserver, jrc, prompts)
    jrc.shutdown()

    rc.plan("threads", workers=8)
    np_params = jax.tree_util.tree_map(np.asarray, jserver.params)
    server = Server("qwen2-moe-a2.7b", device="cpu",
                    params=torch_params(np_params, jserver.cfg))
    got = serve_all(server, rc, prompts)
    assert got == want
    assert all(len(toks) == 16 for toks in got)
