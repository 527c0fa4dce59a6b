"""The port's multi-pod DiLoCo driver (``repro_torch.launch.train``) on the
CPU: a mirror of tests/test_multipod.py's six rows on the port's cluster
backend, and parity with the JAX package's driver from the same parameters.

Pods are the port's cluster workers (``device="cpu"``), on the smoke
xLSTM-125M. Parity: the port's ``pod_round`` called in-process against the
reference's, the final loss within rtol 1e-4 (the tolerance of
``test_train_step_loss_curve_matches_jax``) and every delta leaf within
``LEAF_RTOL``; both drivers for 2 rounds with compression on and off, each
round's loss within rtol 1e-4 and every final parameter leaf's move within
``LEAF_RTOL``; and the flat parameter lists mapped leaf for leaf both ways
(``convert.flat_params_from_jax`` / ``flat_params_to_jax``).
"""

import os
import time

import numpy as np
import pytest
import torch
from _torch_parity import _reset_port  # noqa: F401

import repro_torch.core as rc
from repro_torch.configs import get_arch
from repro_torch.convert import (flat_params_from_jax, flat_params_to_jax,
                                 params_from_jax)
from repro_torch.launch.train import MultiPodDriver, PodRunConfig, pod_round
from repro_torch.tree import leaves

#: the reference's straggler row waits 25 s for a pod sleeping 30 s, which
#: the driver's load can push past (ROADMAP R1); here the straggler sleeps
#: 120 s and the round must end within 60: "raced", not "waited"
STRAGGLE_S, STRAGGLE_BOUND_S = 120.0, 60.0

#: a leaf's difference from the reference, in L2 norm, over its own delta's
#: (or move's). Elementwise bounds do not hold: AdamW moves an element with
#: a near-zero gradient by about lr whatever its sign, so the two packages
#: part on a few such elements (3 of 16384 in one leaf past 5% of the
#: largest move after 2 compressed rounds) while every leaf's norm agrees
#: within 1%. A zeroed leaf reads 1, the outer step without its momentum
#: term far over 0.05.
LEAF_RTOL = 0.05


def _cfg(**kw):
    base = dict(arch="xlstm-125m", pods=2, rounds=3, local_steps=3,
                batch=2, seq=32, smoke=True, device="cpu")
    base.update(kw)
    return PodRunConfig(**base)


# --------------------------------------------------------------------------
# tests/test_multipod.py's rows
# --------------------------------------------------------------------------

def test_multipod_loss_decreases():
    driver = MultiPodDriver(_cfg())
    hist = driver.run()
    assert len(hist) == 3
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_multipod_compression_matches_uncompressed_roughly():
    d1 = MultiPodDriver(_cfg(compress=True))
    h1 = d1.run()
    rc.shutdown()
    d2 = MultiPodDriver(_cfg(compress=False))
    h2 = d2.run()
    # int8+EF must not derail the loss trajectory
    assert abs(h1[-1]["loss"] - h2[-1]["loss"]) < 0.5


def test_multipod_survives_node_failure(tmp_path):
    marker = str(tmp_path / "pod-died")
    driver = MultiPodDriver(_cfg(fail_marker=marker, rounds=2))
    hist = driver.run()
    assert len(hist) == 2                  # round completed despite the kill
    assert os.path.exists(marker)          # the failure really happened
    assert [pod for pod, _ in hist[0]["redispatched"]] == [0]
    assert hist[1]["redispatched"] == []


def test_multipod_straggler_speculation():
    driver = MultiPodDriver(_cfg(
        pods=2, rounds=1, straggle_pod=1, straggle_s=STRAGGLE_S,
        straggler_timeout_s=2.0))
    t0 = time.time()
    hist = driver.run()
    wall = time.time() - t0
    assert len(hist) == 1
    assert wall < STRAGGLE_BOUND_S         # did not wait out the straggler


def test_multipod_elastic_resize():
    driver = MultiPodDriver(_cfg(rounds=1))
    driver.run_round(0)
    driver.resize(3)
    rec = driver.run_round(1)
    assert rec["round"] == 1
    assert driver.cfg.pods == 3
    assert len(driver.ef) == 3


def test_multipod_checkpoints(tmp_path):
    driver = MultiPodDriver(_cfg(rounds=2, ckpt_dir=str(tmp_path / "ck")))
    driver.run()
    assert driver.ckpt.latest_step() == 2
    template = {str(i): torch.from_numpy(p)
                for i, p in enumerate(driver.params)}
    restored, step = driver.ckpt.restore(template)
    assert step == 2
    for i, p in enumerate(driver.params):
        assert np.array_equal(restored[str(i)].numpy(), p)


# --------------------------------------------------------------------------
# the port's own rows
# --------------------------------------------------------------------------

def test_pod_round_reports_its_process_and_refuses_a_missing_card():
    cfg = get_arch("xlstm-125m", smoke=True)
    flat = [p.numpy() for p in leaves(_port_model_params(cfg))]
    out = pod_round("xlstm-125m", True, flat, 0, 0, 2, 1, 2, 32, 1e-3, 0,
                    device="cpu")
    assert out["pid"] == os.getpid() and out["device"] == "cpu"
    assert out["launches"] == {}           # the plain path launches nothing
    assert [d.shape for d in out["delta"]] == [p.shape for p in flat]
    assert all(d.dtype == np.float32 for d in out["delta"])
    with pytest.raises(ValueError, match="parameter arrays"):
        pod_round("xlstm-125m", True, flat[:-1], 0, 0, 2, 1, 2, 32, 1e-3, 0,
                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pod_round("xlstm-125m", True, flat, 0, 0, 2, 1, 2, 32, 1e-3, 0)


def _assert_leaves_close(got, want):
    """Each leaf of ``got`` within ``LEAF_RTOL`` of ``want``'s in L2 norm,
    shapes equal."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        err = float(np.linalg.norm(a - b))
        assert err <= LEAF_RTOL * float(np.linalg.norm(b)), (i, a.shape, err)


def _port_model_params(cfg):
    from repro_torch.models import Model
    return Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_flat():
    """The reference driver's initial flat list (``tree_leaves`` of a JAX
    ``Model.init``) of the smoke xLSTM-125M."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_arch as jax_arch
    from repro.models import Model as JModel
    tree = JModel(jax_arch("xlstm-125m", smoke=True)).init(
        jax.random.PRNGKey(0))
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def test_flat_params_map_leaf_for_leaf_both_ways(ref_flat):
    import jax
    from repro.configs import get_arch as jax_arch
    from repro.models import Model as JModel
    cfg = get_arch("xlstm-125m", smoke=True)
    tree = jax.tree_util.tree_map(
        np.asarray, JModel(jax_arch("xlstm-125m", smoke=True)).init(
            jax.random.PRNGKey(0)))
    port = flat_params_from_jax(ref_flat, cfg)
    want = [p.numpy() for p in leaves(params_from_jax(tree, cfg,
                                                      device="cpu"))]
    assert len(port) == len(want) == len(ref_flat)
    assert [p.shape for p in port] != [p.shape for p in ref_flat]
    for a, b in zip(port, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    back = flat_params_to_jax(port, cfg)
    for a, b in zip(back, ref_flat):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="parameter leaves"):
        flat_params_from_jax(ref_flat[:-1], cfg)
    swapped = list(port)
    swapped[0] = swapped[0].T
    with pytest.raises(ValueError, match="shape"):
        flat_params_to_jax(swapped, cfg)


def test_pod_round_in_process_matches_jax(ref_flat):
    from repro.launch.train import pod_round as jax_pod_round
    cfg = get_arch("xlstm-125m", smoke=True)
    args = (1, 1, 2, 3, 2, 32, 1e-3, 0)    # round 1 of pod 1 of 2, 3 steps
    want = jax_pod_round("xlstm-125m", True, ref_flat, *args)
    got = pod_round("xlstm-125m", True, flat_params_from_jax(ref_flat, cfg),
                    *args, device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["tokens"] == want["tokens"] == 3 * 2 * 32
    _assert_leaves_close(flat_params_to_jax(got["delta"], cfg),
                         [np.asarray(d) for d in want["delta"]])


def test_drivers_match_jax_round_by_round(ref_flat):
    """Both drivers for 2 rounds from the same parameters, with the int8
    exchange and without it; each pool serves both runs warm."""
    import repro.core as jrc
    from repro.launch.train import MultiPodDriver as JDriver
    from repro.launch.train import PodRunConfig as JConfig
    cfg = get_arch("xlstm-125m", smoke=True)
    kw = dict(arch="xlstm-125m", pods=2, rounds=2, local_steps=2, batch=2,
              seq=32, smoke=True)
    try:
        for compress in (True, False):
            ref = JDriver(JConfig(compress=compress, **kw))
            ref.params = [p.copy() for p in ref_flat]
            want = [r["loss"] for r in ref.run()]
            port = MultiPodDriver(
                PodRunConfig(compress=compress, device="cpu", **kw),
                params=flat_params_from_jax(ref_flat, cfg))
            got = [r["loss"] for r in port.run()]
            np.testing.assert_allclose(got, want, rtol=1e-4)
            _assert_leaves_close(
                [a - p for a, p in zip(flat_params_to_jax(port.params, cfg),
                                       ref_flat)],
                [b - p for b, p in zip(ref.params, ref_flat)])
    finally:
        jrc.shutdown()
