"""Optimiser, checkpoint, data pipeline and trainer of the port on the CPU:
the training half of tests/test_substrate.py, mirrored, plus checkpoints
restored across the two packages in both directions. The port has no
GQA model yet, so xLSTM and RecurrentGemma stand in for yi-9b."""

import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import _reset_port, jax_params, n  # noqa: E402,F401

import repro_torch.core as rc  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.data import synth_batch as jax_synth_batch  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.data import Prefetcher, synth_batch  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig,  # noqa: E402
                               init_train_state, make_train_step)
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import leaves, map_with_path  # noqa: E402

XLSTM = "xlstm-125m"
RG = "recurrentgemma-9b"


def _flat(tree) -> dict:
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(path, n(leaf)), tree)
    return out


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_adamw_reduces_loss_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_state(params)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    for _ in range(50):
        w = params["w"].detach().requires_grad_(True)
        grads = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, state, metrics = adamw.apply_updates(cfg, params, grads,
                                                     state)
    assert float(loss(params)) < 0.1
    assert float(metrics["grad_norm"]) >= 0


def test_grad_clipping():
    cfg = AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = adamw.init_state(params)
    huge = {"w": torch.full((4,), 1e6)}
    new, _, metrics = adamw.apply_updates(cfg, params, huge, state)
    assert float(metrics["grad_norm"]) > 1e5   # reported pre-clip
    assert torch.all(new["w"].abs() <= 1.001e-3)


def test_adamw_keeps_param_dtype_and_inputs():
    """bf16 params come back bf16 with fp32 moments; the inputs are left
    as they were."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    params = {"w": torch.ones(2, 3, dtype=torch.bfloat16)}
    state = adamw.init_state(params)
    grads = {"w": torch.ones(2, 3, dtype=torch.bfloat16)}
    new, new_state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert new["w"].dtype == torch.bfloat16
    assert new_state["m"]["w"].dtype == torch.float32
    assert torch.equal(params["w"], torch.ones(2, 3, dtype=torch.bfloat16))
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1


def test_synth_batch_deterministic():
    cfg = get_arch(XLSTM, smoke=True)
    b1 = synth_batch(cfg, batch=2, seq=16, seed=5, step=3)
    b2 = synth_batch(cfg, batch=2, seq=16, seed=5, step=3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = synth_batch(cfg, batch=2, seq=16, seed=5, step=4)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    want = jax_synth_batch(jax_arch(XLSTM, smoke=True), batch=2, seq=16,
                           seed=5, step=3)
    assert sorted(b1) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(b1[k], want[k])


def test_prefetcher_order_and_content():
    cfg = get_arch(XLSTM, smoke=True)
    rc.plan("threads", workers=2)
    pf = Prefetcher(cfg, batch=2, seq=16, seed=9, prefetch=2, device="cpu")
    got = [pf.next_batch() for _ in range(4)]
    want = [synth_batch(cfg, batch=2, seq=16, seed=9, step=i)
            for i in range(4)]
    for g, w in zip(got, want):
        assert isinstance(g["tokens"], torch.Tensor)
        np.testing.assert_array_equal(n(g["tokens"]), w["tokens"])
        np.testing.assert_array_equal(n(g["labels"]), w["labels"])
    rc.shutdown()


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
             "l": [torch.zeros((), dtype=torch.int32)]}
    for step in (10, 20, 30):
        mgr.save(step, {"a": state["a"] + step, "b": {"c": state["b"]["c"]
                                                      + step},
                        "l": [state["l"][0] + step]})
    assert mgr.latest_step() == 30
    restored, step = mgr.restore(state)
    assert step == 30
    np.testing.assert_allclose(n(restored["a"]), n(state["a"]) + 30)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert float(restored["b"]["c"][0]) == 31.0
    assert restored["l"][0].dtype == torch.int32 and \
        int(restored["l"][0]) == 30
    # retention: only 2 kept
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert sorted(kept) == ["step_00000020", "step_00000030"]


def test_async_checkpoint_overlaps(tmp_path):
    rc.plan("threads", workers=2)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = {"w": torch.ones(64, 64)}
    mgr.save(1, state)
    mgr.wait()
    assert mgr.latest_step() == 1
    assert not mgr.save_in_flight()
    rc.shutdown()


def test_checkpoint_snapshots_at_save(tmp_path):
    """The write runs later as a future, but what it writes is the state
    at save(): a change after save() is not in the checkpoint."""
    rc.plan("threads", workers=2)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = {"w": torch.zeros(8)}
    mgr.save(1, state)
    state["w"].add_(5)
    mgr.wait()
    restored, _ = mgr.restore(state)
    assert torch.equal(restored["w"], torch.zeros(8))
    rc.shutdown()


def test_trainer_loss_decreases(tmp_path):
    cfg = get_arch(XLSTM, smoke=True)
    tcfg = TrainerConfig(steps=30, batch=4, seq=32, log_every=10,
                         ckpt_every=15, ckpt_dir=str(tmp_path / "ckpt"),
                         device="cpu")
    trainer = Trainer(cfg, tcfg,
                      AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=30))
    state, history = trainer.run()
    assert history[-1]["loss"] < history[0]["loss"]
    assert [h["step"] for h in history] == [10, 20, 30]
    assert trainer.ckpt.latest_step() == 30
    restored, _ = trainer.ckpt.restore(state)
    for a, b in zip(leaves(restored), leaves(state)):
        assert torch.equal(a, b)


def test_trainer_restart_from_checkpoint(tmp_path):
    """Fault-tolerance: a second trainer resumes from the survivor ckpt."""
    cfg = get_arch(XLSTM, smoke=True)
    ckpt_dir = str(tmp_path / "ckpt")
    tcfg = TrainerConfig(steps=20, batch=2, seq=16, log_every=5,
                         ckpt_every=10, ckpt_dir=ckpt_dir, device="cpu")
    t1 = Trainer(cfg, tcfg)
    state, _ = t1.init_or_restore()
    # run only to step 10 (simulate crash after first checkpoint)
    t1.tcfg = TrainerConfig(**{**tcfg.__dict__, "steps": 10})
    t1.run(state, start_step=0)

    t2 = Trainer(cfg, tcfg)
    state2, start = t2.init_or_restore()
    assert start == 10 and int(state2.opt["step"]) == 10
    _, hist = t2.run(state2, start_step=start)
    assert hist[-1]["step"] == 20


def test_trainer_params_follow_the_seed():
    """init_or_restore draws from a generator on the trainer's device
    seeded with ``seed``: the same seed gives the same params."""
    cfg = get_arch(XLSTM, smoke=True)
    draws = [Trainer(cfg, TrainerConfig(seed=s, device="cpu"))
             .init_or_restore()[0].params for s in (3, 3, 4)]
    a, b, c = (list(leaves(d)) for d in draws)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_trainer_bf16_params_keep_the_scans_fp32(monkeypatch):
    """With bf16 params the blocks widen q, k, v, the gates and the sLSTM
    pre-activations to fp32 before the scans (the CUDA kernels take fp32
    only); a step trains and keeps the params bf16."""
    from repro_torch.kernels import ops
    from repro_torch.models import xlstm as XL
    seen = []

    def spy(name):
        real = getattr(ops, name)

        def call(*args, **kw):
            seen.append((name, {a.dtype for a in args}))
            return real(*args, **kw)
        return call

    monkeypatch.setattr(XL.ops, "mlstm_scan", spy("mlstm_scan"))
    monkeypatch.setattr(XL.ops, "slstm_scan", spy("slstm_scan"))
    cfg = get_arch(XLSTM, smoke=True)
    tcfg = TrainerConfig(steps=1, batch=2, seq=512, log_every=1,
                         param_dtype=torch.bfloat16, device="cpu")
    state, history = Trainer(cfg, tcfg).run()
    assert {name for name, _ in seen} == {"mlstm_scan", "slstm_scan"}
    assert all(dtypes == {torch.float32} for _, dtypes in seen)
    assert np.isfinite(history[0]["loss"])
    assert {p.dtype for p in leaves(state.params)} >= {torch.bfloat16}
    assert state.params["embed"]["table"].dtype == torch.bfloat16


def test_microbatch_accumulation_matches_full():
    """On RecurrentGemma, whose second stage is stacked."""
    jcfg, cfg = jax_arch(RG, smoke=True), get_arch(RG, smoke=True)
    _, npp = jax_params(jcfg, seed=0)
    state = init_train_state(params_from_jax(npp, cfg, device="cpu"))
    batch = _t(synth_batch(cfg, batch=4, seq=16, seed=0, step=0))
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    s1, m1 = make_train_step(Model(cfg), opt, microbatches=1)(state, batch)
    s2, m2 = make_train_step(Model(cfg), opt, microbatches=2)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    a, b = next(leaves(s1.params)), next(leaves(s2.params))
    np.testing.assert_allclose(n(a), n(b), atol=2e-5)


def test_remat_policies_same_loss():
    """At S=512, the chunkwise mLSTM form."""
    jcfg, cfg = jax_arch(XLSTM, smoke=True), get_arch(XLSTM, smoke=True)
    _, npp = jax_params(jcfg, seed=0)
    params = params_from_jax(npp, cfg, device="cpu")
    batch = _t(synth_batch(cfg, batch=2, seq=512, seed=0, step=0))
    losses = []
    for remat in ("none", "full", "dots"):
        (loss, _), grads = value_and_grad(Model(cfg, remat=remat), params,
                                           batch)
        losses.append(float(loss))
        assert np.isfinite(float(adamw.global_norm(grads)))
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)


@pytest.fixture
def jax_state():
    """A JAX TrainState of the smoke xLSTM, one AdamW step in (so m, v and
    step are not zero)."""
    from repro.models import Model as JModel
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.train import make_train_step as jax_train_step
    jcfg = jax_arch(XLSTM, smoke=True)
    jp, _ = jax_params(jcfg, seed=0)
    batch = {k: jnp.asarray(v) for k, v in
             jax_synth_batch(jcfg, batch=2, seq=16, seed=0, step=0).items()}
    state, _ = jax.jit(jax_train_step(JModel(jcfg), JAdamWConfig()))(
        jax_init_state(jp), batch)
    return state


def _jax_flat(tree) -> dict:
    from repro.checkpoint.manager import _flatten
    return _flatten(tree)


def test_jax_checkpoint_restores_into_the_port(tmp_path, jax_state):
    JaxCheckpointManager(str(tmp_path), async_save=False).save(1, jax_state)
    cfg = get_arch(XLSTM, smoke=True)
    template = init_train_state(
        Model(cfg).init(torch.Generator(), device="cpu"))
    got, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 1 and int(got.opt["step"]) == 1
    assert got.opt["step"].dtype == torch.int32
    want = _jax_flat(jax_state)
    mine = _flat(got)
    assert sorted(mine) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(mine[k], want[k])


def test_port_checkpoint_restores_into_jax(tmp_path, jax_state):
    cfg = get_arch(XLSTM, smoke=True)
    mine = train_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jax_state),
                                cfg, device="cpu")
    CheckpointManager(str(tmp_path), async_save=False).save(1, mine)
    template = jax.tree_util.tree_map(jnp.zeros_like, jax_state)
    got, step = JaxCheckpointManager(str(tmp_path)).restore(template)
    assert step == 1
    assert got.opt["step"].dtype == jnp.int32
    want, back = _flat(mine), _jax_flat(got)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_prefetcher_overlaps_a_slow_producer(monkeypatch):
    """With two thread workers the window's futures run while the caller
    works: four batches that take 0.3 s each, fetched by a caller that
    works 0.3 s after each, take about 1.5 s, against 2.4 s one after the
    other (the bound sits between, with room for a loaded host)."""
    from repro_torch.data import pipeline

    def slow(*args, **kw):
        time.sleep(0.3)
        return synth_batch(*args, **kw)

    monkeypatch.setattr(pipeline, "synth_batch", slow)
    rc.plan("threads", workers=2)
    pf = Prefetcher(get_arch(XLSTM, smoke=True), batch=1, seq=8, seed=0,
                    device="cpu")
    t0 = time.perf_counter()
    for _ in range(4):
        pf.next_batch()
        time.sleep(0.3)
    wall = time.perf_counter() - t0
    rc.shutdown()
    assert wall < 2.1, wall
