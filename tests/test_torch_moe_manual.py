"""Manual expert parallelism (``moe_apply_manual``) on 8 gloo ranks, a
(data=2, model=4) mesh, against the JAX package: the mirror of
tests/test_moe_manual.py. The JAX side runs in a subprocess with 8 fake
host devices, as the reference test does; the port's ranks get the same
parameters and input through numpy, each rank its own experts and data rows.
"""

import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from _torch_dist_harness import run as run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (2, 4)                       # (data, model)

_JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.compat import set_mesh
from repro.models.moe import MoEDims, moe_init, moe_apply, moe_apply_manual

np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
# capacity high enough that neither path drops tokens
dims = MoEDims(d_model=64, n_experts=8, top_k=2, d_expert=32, n_shared=2,
               capacity_factor=16.0)
dims_pad = MoEDims(d_model=64, n_experts=10, top_k=2, d_expert=32,
                   capacity_factor=16.0, n_experts_padded=12)
key = jax.random.PRNGKey(0)
p = moe_init(key, dims, jnp.float32)
p2 = moe_init(jax.random.fold_in(key, 2), dims_pad, jnp.float32)
x = jax.random.normal(jax.random.fold_in(key, 1), (4, 16, 64))
mesh = jax.make_mesh((2, 4), ("data", "model"))

def loss(p):
    y, aux = moe_apply_manual(p, x, dims, mesh)
    return jnp.sum(y ** 2) + aux

out = {"x": np.asarray(x)}
for name, d, pp in (("main", dims, p), ("padded", dims_pad, p2)):
    y_auto, aux_auto = moe_apply(pp, x, d)
    with set_mesh(mesh):
        y_man, aux_man = jax.jit(
            lambda p, x: moe_apply_manual(p, x, d, mesh))(pp, x)
    out[name] = {"dims": dataclasses.asdict(d), "params": np_tree(pp),
                 "y_auto": np.asarray(y_auto), "aux_auto": float(aux_auto),
                 "y_man": np.asarray(y_man), "aux_man": float(aux_man)}
with set_mesh(mesh):
    out["main"]["grads"] = np_tree(jax.jit(jax.grad(loss))(p))
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def runs():
    """(the JAX package's results, each port rank's results)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp, "jax.pkl")
        proc = subprocess.run(
            [sys.executable, "-c", _JAX_SCRIPT, str(path)],
            capture_output=True, text=True, timeout=150,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "HOME": tmp}, cwd=str(ROOT))
        assert proc.returncode == 0, proc.stderr[-3000:]
        ref = pickle.loads(path.read_bytes())
    payload = {"mesh": MESH, "x": ref["x"],
               **{c: {"dims": ref[c]["dims"], "params": ref[c]["params"]}
                  for c in ("main", "padded")}}
    ranks = run_ranks("moe", MESH[0] * MESH[1], payload)
    return ref, ranks


def _y(ranks, case):
    """y over the whole batch: each data rank's rows (model rank 0's), in
    data order; every model rank of a data rank holds the same rows."""
    by_data = {}
    for r in ranks:
        d, _ = r["coord"]
        by_data.setdefault(d, []).append(r[case]["y"])
    for parts in by_data.values():
        for y in parts[1:]:
            np.testing.assert_array_equal(y, parts[0])
    return np.concatenate([by_data[d][0] for d in sorted(by_data)])


@pytest.mark.parametrize("case", ["main", "padded"])
def test_manual_y_matches_jax_auto_and_manual(runs, case):
    ref, ranks = runs
    y = _y(ranks, case)
    np.testing.assert_allclose(y, ref[case]["y_auto"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y, ref[case]["y_man"], rtol=2e-5, atol=2e-5)


def test_manual_aux_matches_jax_manual(runs):
    """aux is the mean over data ranks of each one's balance loss: equal
    on every rank, and the JAX manual path's; within 2e-3 of the auto
    path's global one, as the reference test holds it."""
    ref, ranks = runs
    auxes = [r["main"]["aux"] for r in ranks]
    assert len(set(auxes)) == 1
    np.testing.assert_allclose(auxes[0], ref["main"]["aux_man"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(auxes[0], ref["main"]["aux_auto"], atol=2e-3)


def test_manual_grads_match_jax_grad(runs):
    """The grads of sum(y^2) + aux: each rank's (summed over data) expert
    grads are its slice of JAX's, and the router and shared-MLP grads are
    JAX's whole on every rank (pcopy gathers the other ranks' shares)."""
    ref, ranks = runs
    want = ref["main"]["grads"]
    epp = want["w_gate"].shape[0] // MESH[1]

    def close(got, exp):
        np.testing.assert_allclose(got, exp, rtol=1e-4,
                                   atol=1e-5 * np.abs(exp).max())

    for r in ranks:
        _, m = r["coord"]
        got = r["main"]["grads"]
        for k in ("w_gate", "w_up", "w_down"):
            close(got[k], want[k][m * epp:(m + 1) * epp])
        close(got["router"], want["router"])
        for k in want["shared"]:
            close(got["shared"][k], want["shared"][k])
    assert np.abs(want["router"]).max() > 0
