"""The port's sharding specs and meshes against the JAX package's
(``repro/models/sharding.py``, ``repro/train/state.py:train_state_specs``,
``repro/launch/mesh.py``), and the mirror of tests/test_launch.py's spec
rows. Shapes at full size come from ``Model.init(..., device="meta")`` in the
port and ``jax.eval_shape`` in JAX; both spec trees are compared leaf by leaf
by path. ``make_production_mesh`` runs on a fake process group of 256 and
512 ranks, ``shard_tree`` on 4 gloo ranks.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_dist_harness import run as run_ranks  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.data import synth_batch  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.train.state import train_state_specs as jax_train_specs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.train.state import train_state_specs  # noqa: E402
from repro_torch.tree import map_with_path  # noqa: E402

AX = {"data": 16, "model": 16}
AXIS_SETS = {"default": None, "data2_model4": {"data": 2, "model": 4}}


def _jax_flat(tree) -> dict:
    """{port path: tuple spec} of a JAX PartitionSpec pytree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_flat(tree) -> dict:
    out = {}
    map_with_path(lambda path, s: out.__setitem__(path, tuple(s)), tree)
    return out


def _shapes(name):
    """(JAX shape tree, port meta tree) of the full config's params."""
    js = jax.eval_shape(lambda k: JModel(jax_arch(name)).init(k),
                        jax.random.PRNGKey(0))
    return js, Model(get_arch(name)).init(torch.Generator(), device="meta")


@pytest.mark.parametrize("axes", list(AXIS_SETS), ids=list(AXIS_SETS))
@pytest.mark.parametrize("name", all_archs())
def test_param_zero_and_train_state_specs_match_jax(name, axes):
    ax = AXIS_SETS[axes]
    js, ps = _shapes(name)
    want = _jax_flat(jshd.param_specs(js, ax))
    assert _port_flat(shd.param_specs(ps, ax)) == want
    assert _port_flat(shd.zero_specs(ps, axis_sizes=ax)) \
        == _jax_flat(jshd.zero_specs(js, axis_sizes=ax))
    for zero in (True, False):
        jt = jax_train_specs(js, zero=zero, axis_sizes=ax)
        pt = train_state_specs(ps, zero=zero, axis_sizes=ax)
        assert _port_flat(pt.params) == want
        for k in ("m", "v"):
            assert _port_flat(pt.opt[k]) == _jax_flat(jt.opt[k])
        assert tuple(pt.opt["step"]) == tuple(jt.opt["step"]) == ()
    # a spec names no axis a dim cannot divide over
    sizes = ax or shd.DEFAULT_AXIS_SIZES
    shapes = {}
    map_with_path(lambda p, t: shapes.__setitem__(p, tuple(t.shape)), ps)
    for path, spec in want.items():
        for size, a in zip(shapes[path], spec):
            if a is not None:
                assert size % shd._axis_len(a, sizes) == 0, (path, spec)


@pytest.mark.parametrize("axes", list(AXIS_SETS), ids=list(AXIS_SETS))
@pytest.mark.parametrize("name", all_archs())
def test_batch_and_cache_specs_match_jax(name, axes):
    """Batches of 32 and of 1 (one that divides over DP and one that
    cannot) and the decode caches at B=32, S=4096; an encoder-only config
    has no cache in the port (``init_cache`` raises), so its specs run on
    the JAX cache's shapes."""
    ax = AXIS_SETS[axes]
    jcfg, cfg = jax_arch(name), get_arch(name)
    for b in (32, 1):
        batch = synth_batch(jcfg, batch=b, seq=16, seed=0, step=0)
        for axes_ in (("data",), ("pod", "data")):
            want = _jax_flat(jshd.batch_specs(
                {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in batch.items()}, batch_axes=axes_,
                axis_sizes=ax))
            got = _port_flat(shd.batch_specs(
                {k: torch.from_numpy(v) for k, v in batch.items()},
                batch_axes=axes_, axis_sizes=ax))
            assert got == want
    jc = jax.eval_shape(lambda: JModel(jcfg).init_cache(32, 4096,
                                                        jnp.float32))
    if cfg.decode_capable:
        pc = Model(cfg).init_cache(32, 4096, device="meta",
                                   dtype=torch.float32)
    else:
        with pytest.raises(ValueError):
            Model(cfg).init_cache(32, 4096, device="meta")
        pc = jax.tree_util.tree_map(
            lambda s: torch.empty(s.shape, device="meta"), jc)
    for rep in (False, True):
        want = _jax_flat(jshd.cache_specs(jc, batch_replicated=rep,
                                          axis_sizes=ax))
        assert _port_flat(shd.cache_specs(pc, batch_replicated=rep,
                                          axis_sizes=ax)) == want


# -- the mirror of tests/test_launch.py's spec rows -------------------------

def test_param_specs_divisibility():
    cfg = get_arch("minicpm3-4b")           # vocab 73448 NOT /16
    shapes = Model(cfg).init(torch.Generator(), device="meta",
                             dtype=torch.bfloat16)
    specs = shd.param_specs(shapes, AX)
    flat_shapes = {}
    map_with_path(lambda p, t: flat_shapes.__setitem__(p, t.shape), shapes)
    for path, spec in _port_flat(specs).items():
        for size, ax in zip(flat_shapes[path], spec):
            if ax is not None:
                n = AX.get(ax, 1) if not isinstance(ax, tuple) else \
                    int(np.prod([AX.get(a, 1) for a in ax]))
                assert size % n == 0, (path, flat_shapes[path], spec)
    assert tuple(specs["embed"]["table"]) == (None, None)


def test_param_specs_shard_big_weights():
    shapes = Model(get_arch("yi-9b")).init(torch.Generator(), device="meta",
                                           dtype=torch.bfloat16)
    specs = shd.param_specs(shapes, AX)
    # embedding sharded over model
    assert tuple(specs["embed"]["table"]) == ("model", None)
    # scanned stage weights: leading layer axis unsharded, ffn dim sharded
    stage = specs["stages"][0]
    assert tuple(stage["b0"]["mlp"]["w_up"]) == (None, None, "model")
    assert tuple(stage["b0"]["mlp"]["w_down"]) == (None, "model", None)


def test_zero_specs_add_data_axis():
    shapes = Model(get_arch("yi-9b")).init(torch.Generator(), device="meta",
                                           dtype=torch.bfloat16)
    zspecs = shd.zero_specs(shapes, axis_sizes=AX)
    spec = tuple(zspecs["stages"][0]["b0"]["mlp"]["w_up"])
    assert "data" in spec and "model" in spec


def test_batch_specs_replicate_tiny_batch():
    batch = {"tokens": torch.empty((1, 1024), dtype=torch.int32,
                                   device="meta")}
    specs = shd.batch_specs(batch, batch_axes=("data",), axis_sizes=AX)
    assert tuple(specs["tokens"]) == (None, None)
    batch = {"tokens": torch.empty((256, 1024), dtype=torch.int32,
                                   device="meta")}
    specs = shd.batch_specs(batch, batch_axes=("data",), axis_sizes=AX)
    assert tuple(specs["tokens"]) == ("data", None)


# -- meshes ------------------------------------------------------------------

@pytest.fixture
def fake_group():
    """A fake process group of the asked size (this process its rank 3)."""
    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=3,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_on_a_fake_group(fake_group, multi_pod):
    fake_group(512 if multi_pod else 256)
    mesh = pmesh.make_production_mesh(multi_pod, device_type="cpu")
    want = (2, 16, 16) if multi_pod else (16, 16)
    assert tuple(mesh.shape) == want
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                   else ("data", "model"))
    assert tuple(mesh.get_coordinate()) == ((0, 0, 3) if multi_pod
                                            else (0, 3))
    assert pmesh.data_axes(mesh) == (("pod", "data") if multi_pod
                                     else ("data",))
    # the jax reference's axis sizes are the mesh's
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {
        k: v for k, v in shd.DEFAULT_AXIS_SIZES.items()
        if k in mesh.mesh_dim_names}
    # a 340B tree's table (64000 is not 340B's vocab; the shard's shape is
    # what counts) cut on meta costs nothing: (64000/16, 4096) a rank
    table = torch.empty((64000, 4096), device="meta")
    local = shd.local_shard(table, shd.Spec("model", None), mesh)
    assert tuple(local.shape) == (4000, 4096)
    assert shd.placements(shd.Spec(("pod", "data") if multi_pod else "data",
                                   "model"), mesh) == (
        (Shard(0), Shard(0), Shard(1)) if multi_pod else (Shard(0), Shard(1)))


def test_make_host_mesh_on_one_rank():
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_host_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert dist.get_world_size() == 1
        assert shd.placements(shd.Spec(None, "model"), mesh) == (
            Replicate(), Shard(1))
    finally:
        dist.destroy_process_group()


def test_shard_tree_on_four_gloo_ranks():
    """A (pod=2, data=2, model=1) mesh: a dim over ("pod", "data") is cut
    in 4 with pod outermost, a dim over "data" in 2, "model" (size 1) and
    None keep the dim whole; each rank's shards equal DTensor's
    ``distribute_tensor(...).to_local()`` under ``placements``."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal((4, 10)).astype(np.float32),
            "c": rng.standard_normal((5, 3)).astype(np.float32)}
    specs = {"a": (("pod", "data"), "model"), "b": (None, "data"),
             "c": (None, None)}
    ranks = run_ranks("shard", 4, {"shape": (2, 2, 1),
                                   "names": ("pod", "data", "model"),
                                   "tree": tree, "specs": specs})
    assert sorted(r["coord"] for r in ranks) == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    for r in ranks:
        pod, data, _ = r["coord"]
        assert r["data_axes"] == ("pod", "data")
        want = {"a": tree["a"][2 * (2 * pod + data):2 * (2 * pod + data) + 2],
                "b": tree["b"][:, 5 * data:5 * data + 5],
                "c": tree["c"]}
        for k in tree:
            np.testing.assert_array_equal(r["local"][k], want[k])
            np.testing.assert_array_equal(r["dtensor"][k], want[k])


def test_placements_refuse_axes_out_of_mesh_order(fake_group):
    fake_group(8)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError):
        shd.placements(shd.Spec(("data", "pod"), None), mesh)
    with pytest.raises(ValueError):           # 6 rows over 4 ranks
        shd.local_shard(torch.zeros(6, 2), shd.Spec(("pod", "data"), None),
                        mesh)
