"""The port's training path against the JAX package on the CPU: the loss
and every gradient leaf, AdamW, the train step over several steps,
microbatching and remat. Parameters come from a JAX ``Model.init`` through
``params_from_jax``; batches from ``synth_batch``.

Tolerances: the loss within 1e-5 relative and each grad leaf within 1e-4
of that leaf's largest JAX grad (XLA and ATen sum in other orders, about
1e-6 relative a block, and a leaf's small entries carry the error of its
large ones). One leaf kind takes another scale: the mLSTM input-gate bias
``b_i``. Its grad is the sum over positions of dL/d i_raw, whose terms
cancel to 1e-4 to 1e-5 of its sibling ``w_i``'s grad (the same terms
weighted by the conv output). Measured against the port run in float64 at
these seeds, JAX's own fp32 ``b_i`` grad is 5.5e-4 to 6.2e-3 of its
largest value off, the port's 1.5e-3 to 1.9e-3, and both are within
1.5e-7 of ``w_i``'s largest grad. So ``b_i`` is held to 1e-4 of ``w_i``'s
largest grad. AdamW within 1e-6 relative on the same numpy grads; the loss
curve within 1e-4 relative (Adam's normalised step carries the grads'
rounding into the params); microbatching 1e-5 and remat 1e-6, the same
arithmetic in another grouping.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import (_reset_port, jax_params,  # noqa: E402,F401
                           mlstm_b_i_scales, n, torch_params)

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.data import synth_batch as jax_synth_batch  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import leaves, map_with_path  # noqa: E402

B = 2


def _jax_leaves(tree) -> dict:
    """{path: numpy leaf} with the port's paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _torch_leaves(tree) -> dict:
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(path, n(leaf)), tree)
    return out


def _assert_leaves_close(got: dict, want: dict, frac: float,
                         scale_of: "dict | None" = None) -> None:
    """Each leaf within ``frac`` of that leaf's largest value in ``want``
    (of the leaf ``scale_of[key]``'s, where given)."""
    assert sorted(got) == sorted(want)
    for key in want:
        ref = want[(scale_of or {}).get(key, key)]
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= frac * scale, (key, err, scale)


def _batches(cfg, seq, steps, seed=0, batch=B):
    return [synth_batch(cfg, batch=batch, seq=seq, seed=seed, step=i)
            for i in range(steps)]


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def xlstm():
    jcfg, tcfg = jax_arch("xlstm-125m", smoke=True), \
        get_arch("xlstm-125m", smoke=True)
    jp, npp = jax_params(jcfg, seed=0)
    return jcfg, tcfg, jp, npp


@pytest.mark.parametrize("arch,s", [("xlstm-125m", 32), ("xlstm-125m", 512),
                                    ("recurrentgemma-9b", 32)])
def test_loss_and_grads_match_jax(arch, s):
    """S=32 runs xLSTM's parallel mLSTM form, S=512 its chunkwise (kernel)
    form; RecurrentGemma's stacked stage gets grads on a leading axis."""
    jcfg, tcfg = jax_arch(arch, smoke=True), get_arch(arch, smoke=True)
    jp, npp = jax_params(jcfg, seed=1)
    batch = synth_batch(tcfg, batch=B, seq=s, seed=3, step=0)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        JModel(jcfg).loss, has_aux=True))(jp, _j(batch))
    (loss, metrics), grads = value_and_grad(Model(tcfg),
                                             torch_params(npp, tcfg),
                                             _t(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]),
                               rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    want = _jax_leaves(jg)
    _assert_leaves_close(_torch_leaves(grads), want, 1e-4,
                         mlstm_b_i_scales(tcfg, want))


def test_loss_masks_negative_labels(xlstm):
    """Positions with a label < 0 drop out of the mean, as in JAX."""
    jcfg, tcfg, jp, npp = xlstm
    batch = synth_batch(tcfg, batch=B, seq=16, seed=0, step=0)
    batch["labels"][:, ::3] = -1
    want, _ = JModel(jcfg).loss(jp, _j(batch))
    got, _ = Model(tcfg).loss(torch_params(npp, tcfg), _t(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _opt_case():
    """params with a (3,4) and a (4,) leaf, grads large enough to clip."""
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "blk": [{"b": rng.standard_normal(4).astype(np.float32)}]}
    grads = [{"w": (rng.standard_normal((3, 4)) * 5).astype(np.float32),
              "blk": [{"b": (rng.standard_normal(4) * 5).astype(np.float32)}]}
             for _ in range(3)]
    return params, grads


def test_adamw_matches_jax_on_the_same_grads():
    """3 steps with the clip active, in warmup, a leaf of ndim 1 (not
    decayed) beside a matrix (decayed)."""
    kw = dict(lr=1e-2, grad_clip=1.0, warmup_steps=4, total_steps=10,
              weight_decay=0.1)
    params, grads = _opt_case()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jadamw.init_state(jp)
    tp = {"w": torch.from_numpy(params["w"]),
          "blk": [{"b": torch.from_numpy(params["blk"][0]["b"])}]}
    tstate = adamw.init_state(tp)
    for g in grads:
        jp, jstate, jmet = jadamw.apply_updates(
            JAdamWConfig(**kw), jp, jax.tree_util.tree_map(jnp.asarray, g),
            jstate)
        tg = {"w": torch.from_numpy(g["w"]),
              "blk": [{"b": torch.from_numpy(g["blk"][0]["b"])}]}
        tp, tstate, tmet = adamw.apply_updates(AdamWConfig(**kw), tp, tg,
                                               tstate)
        assert float(jmet["grad_norm"]) > kw["grad_clip"]     # clipped
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-6)
        for got, want in ((tp, jp), (tstate["m"], jstate["m"]),
                          (tstate["v"], jstate["v"])):
            g_, w_ = _torch_leaves(got), _jax_leaves(want)
            for key in w_:
                np.testing.assert_allclose(g_[key], w_[key], rtol=1e-6,
                                           atol=1e-7)
        assert int(tstate["step"]) == int(jstate["step"])
    assert tstate["step"].dtype == torch.int32


@pytest.mark.parametrize("step", [0, 1, 5, 100, 5000, 10000, 20000])
def test_schedule_matches_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000,
               min_lr_ratio=0.1)
    got = adamw.schedule(AdamWConfig(**cfg), torch.tensor(step))
    want = jadamw.schedule(JAdamWConfig(**cfg), jnp.asarray(step))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_step_loss_curve_matches_jax(xlstm):
    """5 steps of the JAX step and the port's from the same TrainState,
    converted by train_state_from_jax, on the same batches. At lr 1e-3 the
    JAX step against itself, with the embeddings moved by one ulp, stays
    within 2.2e-6 at every step; at lr 3e-3 (train_lm.py's smoke rate) it
    drifts to 6.2e-4 by step 5, past the limit, so rounding alone would
    fail there."""
    jcfg, tcfg, jp, _ = xlstm
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jstate = jax_init_state(jp)
    tstate = train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
    jstep = jax.jit(jax_train_step(JModel(jcfg), JAdamWConfig(**kw)))
    tstep = make_train_step(Model(tcfg), AdamWConfig(**kw))
    jl, tl = [], []
    for batch in _batches(tcfg, 32, 5):
        jstate, jm = jstep(jstate, _j(batch))
        tstate, tm = tstep(tstate, _t(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert tm["loss"].ndim == 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert jl[-1] < jl[0]
    assert int(tstate.opt["step"]) == 5


def test_train_state_from_jax_checks_paths(xlstm):
    jcfg, tcfg, jp, _ = xlstm
    state = jax.tree_util.tree_map(np.asarray, jax_init_state(jp))
    del state.opt["m"]["embed"]
    with pytest.raises(ValueError, match="opt/m"):
        train_state_from_jax(state, tcfg, device="cpu")


def test_microbatch_accumulation_matches_full(xlstm):
    """microbatches=2 against 1: the loss, and the params after a step."""
    _, tcfg, _, npp = xlstm
    from repro_torch.train import init_train_state
    state = init_train_state(torch_params(npp, tcfg))
    batch = _t(synth_batch(tcfg, batch=4, seq=16, seed=0, step=0))
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    s1, m1 = make_train_step(Model(tcfg), opt, microbatches=1)(state, batch)
    s2, m2 = make_train_step(Model(tcfg), opt, microbatches=2)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    assert float(m2["aux"]) == 0.0 and float(m2["ce"]) == float(m2["loss"])
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-9b"])
def test_remat_policies_same_loss_and_grads(arch):
    jcfg, tcfg = jax_arch(arch, smoke=True), get_arch(arch, smoke=True)
    _, npp = jax_params(jcfg, seed=2)
    params = torch_params(npp, tcfg)
    batch = _t(synth_batch(tcfg, batch=B, seq=16, seed=0, step=0))
    runs = {remat: value_and_grad(Model(tcfg, remat=remat), params, batch)
            for remat in ("none", "full", "dots")}
    (loss0, _), g0 = runs["none"]
    for remat in ("full", "dots"):
        (loss, _), g = runs[remat]
        np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
        _assert_leaves_close(_torch_leaves(g), _torch_leaves(g0), 1e-6)


def test_unknown_remat_raises(xlstm):
    with pytest.raises(ValueError, match="remat"):
        Model(xlstm[1], remat="offload")


def test_synth_batch_equals_jax_copy():
    """The port's synth_batch is the JAX package's, array for array."""
    for arch in ("xlstm-125m", "qwen2-vl-72b", "hubert-xlarge"):
        cfg = jax_arch(arch, smoke=True)
        want = jax_synth_batch(cfg, batch=2, seq=16, seed=4, step=2,
                               shard=1, n_shards=2)
        got = synth_batch(cfg, batch=2, seq=16, seed=4, step=2, shard=1,
                          n_shards=2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
