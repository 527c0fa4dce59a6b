"""The GPipe pipeline over ``pod`` on 2 gloo ranks, a (pod=2, data=1,
model=1) mesh, against the JAX package's plain loss: the mirror of
tests/test_pipeline.py, with gradients and a train step held leaf by leaf.
yi-9b's smoke config (a uniform stack of 2 layers, one a stage), a batch of
4 in 2 microbatches.

Tolerances: the loss within 2e-4 (the reference test's); each grad leaf
within 1e-4 of its largest JAX grad and the params after one AdamW step
within 1e-5 of each leaf's largest (tests/test_torch_train.py's: XLA and
ATen sum in other orders, and the microbatches split the sums again).
"""

import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_dist_harness import run as run_ranks  # noqa: E402
from _torch_parity import jax_params  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.data import synth_batch  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import pipeline as pp  # noqa: E402
from repro_torch.tree import map_with_path  # noqa: E402

ARCH = "yi-9b"
MESH = (2, 1, 1)                   # (pod, data, model)
OPT = dict(lr=3e-5, warmup_steps=1, total_steps=4)
REMATS = ("none", "full")


def _paths(tree) -> dict:
    """{port path: numpy leaf} of a JAX pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _gathered(ranks, key) -> dict:
    """{path: leaf} of the whole model from each stage's tree under
    ``key``: the stage leaves' (1, L/P, ...) slices joined in stage order
    to (L, ...); every other leaf, the same on each stage, from stage 0."""
    ranks = sorted(ranks, key=lambda r: r["stage"])
    trees = []
    for r in ranks:
        tree = r
        for k in key:
            tree = tree[k]
        flat = {}
        map_with_path(lambda path, leaf: flat.__setitem__(path, leaf), tree)
        trees.append(flat)
    out = {}
    for path in trees[0]:
        parts = [t[path] for t in trees]
        if path.startswith("stages/"):
            whole = np.concatenate(parts)
            out[path] = whole.reshape(-1, *whole.shape[2:])
        else:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0], err_msg=path)
            out[path] = parts[0]
    return out


@pytest.fixture(scope="module")
def runs():
    cfg = jax_arch(ARCH, smoke=True)
    model = JModel(cfg)
    params, np_params = jax_params(cfg)
    batch = {k: jnp.asarray(v) for k, v in
             synth_batch(cfg, batch=4, seq=16, seed=0, step=0).items()}
    (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
        params, batch)
    state, _ = make_train_step(model, JAdamWConfig(**OPT))(
        init_train_state(params), batch)
    ref = {"loss": float(loss), "grads": _paths(grads),
           "params": _paths(state.params)}
    payload = {"mesh": MESH, "arch": ARCH, "params": np_params,
               "batch": {k: np.asarray(v) for k, v in batch.items()},
               "microbatches": 2, "remats": REMATS, "opt": OPT}
    return ref, run_ranks("pipeline", MESH[0], payload)


@pytest.mark.parametrize("remat", REMATS)
def test_pipeline_loss_matches_plain_loss(runs, remat):
    ref, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[remat]["loss"], ref["loss"], rtol=2e-4,
                                   atol=2e-4)
    assert ranks[0][remat]["loss"] == ranks[1][remat]["loss"]


@pytest.mark.parametrize("remat", REMATS)
def test_pipeline_grads_match_jax_grad(runs, remat):
    """Every leaf: the stage leaves joined over the two stages, the
    replicated ones (embedding, unembedding, final norm) summed over
    ``pod`` and the same on both."""
    ref, ranks = runs
    got = _gathered(ranks, (remat, "grads"))
    assert got.keys() == ref["grads"].keys()
    for path, want in ref["grads"].items():
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=path)
        assert np.abs(want).max() > 0, path


def test_pipeline_handoff_carries_both_ways(runs):
    """A message a microbatch each way: stage 0 sends its outputs and
    receives their grads, stage 1 the reverse; CPU tensors cross without
    host copies."""
    _, ranks = runs
    for r in ranks:
        assert r["none"]["handoff"] == (2, 2, 0)


def test_pipeline_train_step_matches_plain_step(runs):
    ref, ranks = runs
    got = _gathered(ranks, ("step", "params"))
    assert got.keys() == ref["params"].keys()
    for path, want in ref["params"].items():
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)
    losses = {r["step"]["loss"] for r in ranks}
    norms = {r["step"]["grad_norm"] for r in ranks}
    assert len(losses) == 1 and len(norms) == 1


def test_stage_specs_and_local_params():
    """``split_stage_params`` and ``stage_param_specs`` against the JAX
    package's on yi-9b's full tree (meta shapes), and
    ``local_stage_params``' slices on a fake 2-stage mesh."""
    from repro.models import sharding as jshd
    from repro.train import pipeline as jpp
    jcfg = jax_arch(ARCH)
    shapes = jax.eval_shape(lambda k: JModel(jcfg).init(k),
                            jax.random.PRNGKey(0))
    jspecs = jpp.stage_param_specs(jshd.param_specs(shapes))
    jsplit = jax.eval_shape(lambda p: jpp.split_stage_params(p, 2), shapes)
    cfg = get_arch(ARCH)
    meta = Model(cfg).init(torch.Generator(), device="meta")
    specs = pp.stage_param_specs(shd.param_specs(meta))
    split = pp.split_stage_params(meta, 2)
    want_specs = {p: tuple(s) for p, s in _paths_specs(jspecs).items()}
    got_specs, got_shapes = {}, {}
    map_with_path(lambda p, s: got_specs.__setitem__(p, tuple(s)), specs)
    map_with_path(lambda p, t: got_shapes.__setitem__(p, tuple(t.shape)),
                  split)
    assert got_specs == want_specs
    assert got_shapes == {p: tuple(a.shape)
                          for p, a in _paths_specs(jsplit).items()}
    with pytest.raises(ValueError):
        pp.split_stage_params(meta, 5)       # 48 layers over 5 stages

    # stage 1 of 2 on a fake process group: its half of the stack, the
    # other leaves whole
    small = Model(get_arch(ARCH, smoke=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=2)
    try:
        mesh = init_device_mesh("cpu", MESH,
                                mesh_dim_names=("pod", "data", "model"))
        local = pp.local_stage_params(small, mesh)
    finally:
        dist.destroy_process_group()
    wq = small["stages"][0]["b0"]["attn"]["wq"]
    assert torch.equal(local["stages"][0]["b0"]["attn"]["wq"],
                       wq.reshape(2, 1, *wq.shape[1:])[1:])
    assert torch.equal(local["embed"]["table"], small["embed"]["table"])


def _paths_specs(tree) -> dict:
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def test_chip_smoke_multidevice_phases_at_smoke_size(monkeypatch, capsys):
    """``chip_smoke.py``'s phases 7a and 7b, every check of them, on the
    CPU at smoke size (the plain kernels: no launch is expected): the
    single-process run of qwen2-moe's smoke config and its 1-ulp
    yardstick, 7a(i) on a (1, 1) gloo mesh, 7a(ii) in two spawned ranks
    drawing their own experts, then 7b's two stages on yi-9b's smoke
    config (a layer a stage)."""
    import importlib
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parents[1]))
    cs = importlib.import_module("chip_smoke")
    cfg = get_arch("qwen2-moe-a2.7b", smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(cs.SEED), device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 64)))}
    n_moe = sum(k == "moe" for k in cfg.layer_pattern)
    with torch.no_grad(), cs.RoutingLog() as log:
        logits = model.apply(params, batch)[0][0]
    with torch.no_grad(), cs.RoutingLog() as alt_log:
        alt = Model(cfg, kernel_impl="plain").apply(
            cs.one_ulp_moved(params), batch)[0][0]
    ref = {"logits": logits, "tokens": batch["tokens"],
           "decisions": log.layers(n_moe),
           "yardstick": (*cs.routing_diff(alt_log.layers(n_moe),
                                          log.layers(n_moe)),
                         cs.err_by_position(alt, logits))}
    ref = cs.ep_one_rank_phase(cfg, params, ref)
    assert not dist.is_initialized()
    cs.ep_ranks_phase(cfg, ref, "cpu", device="cpu", smoke=True)
    cs.pipeline_phase("cpu", device="cpu", smoke=True, layers=2, b=4, s=8)
    out = capsys.readouterr().out
    assert out.count("7a rank") == 4 and "bit for bit: True" in out
    assert out.count("7b stage") == 2
