"""The port's dry-run tooling (``repro_torch.launch.{specs,op_analysis,
dryrun}``) against the JAX package's (``repro/launch/{specs,hlo_analysis,
dryrun}.py``), and the mirror of tests/test_launch.py's analyzer and FLOP
rows (its spec rows are mirrored in tests/test_torch_sharding.py).

Per-device counts are held against the reference's own lowering: a JAX
process with 8 placeholder host devices lowers the smoke configs' steps
on a (2, 4) ``("data", "model")`` mesh and reads them with
``repro.launch.hlo_analysis.analyze``, as the reference's multi-device
tests spawn theirs; the port traces the same cells on a fake group of 8
ranks.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import all_archs  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.op_analysis import (OpCounter,  # noqa: E402
                                            Roofline, _nbytes, _tensors,
                                            analyze)
from repro_torch.tree import map_with_path  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the (2, 4) mesh's cells: the smoke configs' steps at B=8, S=64
MESH = ((2, 4), ("data", "model"))
SMOKE_ARCHS = ("xlstm-125m", "recurrentgemma-9b")
KINDS = ("prefill", "train", "decode")
B, S = 8, 64
# the port's FLOPs a device against the reference's HLO count
FLOPS_REL = 0.10


@pytest.fixture
def fake_group():
    yield dryrun.start_fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


# -- the mirror of tests/test_launch.py's analyzer rows ---------------------

def test_dtype_bytes():
    """test_shape_bytes's rows, on the tensors' types."""
    assert _nbytes([torch.empty(8, 64)]) == 8 * 64 * 4
    assert _nbytes([torch.empty(2, 3, dtype=torch.bfloat16)]) == 12
    assert _nbytes(_tensors((torch.empty((), dtype=torch.int32),
                             torch.empty(4, 4)))) == 4 + 64
    assert _nbytes([torch.empty((), dtype=torch.bool)]) == 1


def test_analyze_loop_trips_and_flops(fake_group):
    """The reference's while-loop fixture as a Python loop: 12 iterations
    of an (8,64).(64,8) product and an all-reduce on a fake group."""
    fake_group(4)

    def body(w):
        for _ in range(12):
            d = w @ w.T
            dist.all_reduce(d)
        return d

    _, r = analyze(body, torch.empty(8, 64, device="meta"))
    # dot: 2 * 8*8 * 64 flops, x12 iterations
    assert r.flops == 12 * 2 * 8 * 8 * 64
    # all-reduce of 8x8 f32: 2x multiplier, x12
    assert r.collectives["all-reduce"] == 12 * 2 * 8 * 8 * 4
    assert r.collective_calls == {"all-reduce": 12}


def test_analyze_loop_of_products():
    """test_analyze_real_jit_scan's scan as 7 steps of tanh(x@w)+c."""
    def f(w, xs):
        c = torch.zeros(4, 16)
        for x in xs:
            c = torch.tanh(x @ w) + c
        return c.sum()

    _, r = analyze(f, torch.randn(16, 16), torch.randn(7, 4, 16))
    assert r.flops == 7 * 2 * 4 * 16 * 16
    assert r.flops_by_dtype == {"float32": 7 * 2 * 4 * 16 * 16}


def test_donated_peak_gives_up_the_arguments_after_their_last_use():
    """The reference's ``donate_argnums``: a donated storage is freed after
    the last op that touches it, unless the step returns it."""
    mib = 2 ** 18                       # fp32 elements in 1 MiB

    def step(a, c):
        b = a * 2                       # a's last use
        c.mul_(2)                       # c, written in place, returned
        d = b + 1
        return d, c

    counter = OpCounter()
    a, c = torch.empty(mib, device="meta"), torch.empty(mib, device="meta")
    with counter:
        counter.hold(a, donate=True)
        counter.hold(c, donate=True)
        out = step(a, c)
    # held to the end: a, c, b and d
    assert counter.roof.peak_bytes == 4 * 4 * mib
    # a given up after the product: c, b and d
    assert counter.donated_peak(out) == 3 * 4 * mib
    # nothing returned: c too is given up after its last use
    assert counter.donated_peak(()) == 3 * 4 * mib - 0
    assert OpCounter().donated_peak(()) == 0


def test_op_rules_leave_dtensor_as_it_was(fake_group):
    """The dry run's rules hold inside ``op_rules`` only: a view DTensor
    refuses is refused again after it, and the handlers are gone."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch import dtensor_rules as DR
    mesh = dryrun.fake_mesh((1, 4), ("data", "model"))
    # 4 heads of 16 over 4 ranks, viewed as 2 heads of 32
    x = DTensor.from_local(torch.empty(2, 1, 16, device="meta"), mesh,
                           [Shard(0), Shard(2)], run_check=False)
    handlers = DTensor._op_dispatcher._custom_op_handlers
    log_sigmoid = torch.ops.aten.log_sigmoid_forward.default
    with pytest.raises(RuntimeError):
        x.view(2, 1, 2, 32)
    with DR.op_rules():
        assert x.view(2, 1, 2, 32).shape == (2, 1, 2, 32)
        assert log_sigmoid in handlers
    with pytest.raises(RuntimeError):
        x.view(2, 1, 2, 32)
    assert log_sigmoid not in handlers


def test_label_nll_keeps_the_batch_split(fake_group):
    """The loss's label pick on DTensors: its backward holds no rank's copy
    of the whole batch's log-probabilities (a ``gather``'s backward makes
    one), and on one rank it is the plain pick, value and gradient."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import dtensor_rules as DR
    mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
    logp = DTensor.from_local(
        torch.empty(4, 16, 32, device="meta", requires_grad=True), mesh,
        [Shard(0), Replicate()], run_check=False)
    labels = DTensor.from_local(
        torch.empty(4, 16, dtype=torch.int64, device="meta"), mesh,
        [Shard(0), Replicate()], run_check=False)
    counter = OpCounter()
    with counter:
        counter.hold((logp, labels))
        DR.label_nll(logp, labels).sum().backward()
    # the local logp and its gradient, beside the small ones: never a
    # tensor of the global (8, 16, 32)
    assert counter.roof.peak_bytes < 3 * 4 * 16 * 32 * 4
    dist.destroy_process_group()

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    one = torch.distributed.device_mesh.init_device_mesh(
        "cpu", (1,), mesh_dim_names=("data",))
    gen = torch.Generator().manual_seed(0)
    x = torch.log_softmax(torch.randn(2, 5, 7, generator=gen), -1)
    y = torch.randint(0, 7, (2, 5), generator=gen)
    xd, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = DR.label_nll(DTensor.from_local(xd, one, [Shard(0)]),
                       DTensor.from_local(y, one, [Shard(0)]))
    want = DR.label_nll(xp, y)
    got.sum().backward()
    want.sum().backward()
    assert torch.equal(got.full_tensor(), want)
    assert torch.equal(xd.grad, xp.grad)


def test_model_flops_sane():
    mf = specs.model_flops(get_arch("yi-9b"), SHAPES["train_4k"])
    # yi-9b ~ 8.8e9 params; 6*N*D with D = 1M tokens ~ 5e16
    assert 8e9 < mf["params_total"] < 10e9
    assert 3e16 < mf["dense_flops"] < 8e16
    assert mf["attn_flops"] > 0


def test_moe_active_params_less_than_total():
    cfg = get_arch("qwen2-moe-a2.7b")
    pc = specs.param_counts(cfg)
    mf = specs.model_flops(cfg, SHAPES["train_4k"])
    assert 13e9 < pc["total"] < 16e9           # ~14.3B total
    assert mf["n_active"] < 0.35 * pc["total"]  # A2.7B active (+unembed)


def test_cell_skip_reasons():
    ok, why = get_arch("hubert-xlarge").supports(SHAPES["decode_32k"])
    assert not ok and "decode" in why
    ok, why = get_arch("yi-34b").supports(SHAPES["long_500k"])
    assert not ok and "quadratic" in why
    assert get_arch("recurrentgemma-9b").supports(SHAPES["long_500k"])[0]


def test_seconds_at_the_h100_peaks():
    r = Roofline(flops=3e12, flops_by_dtype={"bfloat16": 989e12,
                                             "float32": 67e12},
                 hbm_bytes=3.35e12, link_bytes=450e9)
    assert r.seconds(256) == pytest.approx(
        {"compute_s": 2.0, "memory_s": 1.0, "collective_s": 1.0})


# -- parity with the JAX package --------------------------------------------

@pytest.mark.parametrize("name", all_archs())
def test_param_counts_and_model_flops_equal_the_reference(name):
    cfg, jcfg = get_arch(name), jax_arch(name)
    assert specs.param_counts(cfg) == jspecs.param_counts(jcfg)
    for shape in SHAPES:
        assert specs.model_flops(cfg, SHAPES[shape]) == \
            jspecs.model_flops(jcfg, JSHAPES[shape])


def test_tables_equal_the_reference():
    assert specs.MICROBATCHES == jspecs.MICROBATCHES
    assert specs.REMAT == jspecs.REMAT


@pytest.mark.parametrize("name", all_archs())
def test_batch_struct_equals_the_reference(name):
    got = specs.batch_struct(get_arch(name), 4, 96)
    want = jspecs.batch_struct(jax_arch(name), 4, 96)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)
    t = specs.batch_struct(get_arch(name), 2, 8, dtype=torch.float32)
    w = jspecs.batch_struct(jax_arch(name), 2, 8, dtype=jnp.float32)
    assert [str(v.dtype).removeprefix("torch.") for v in t.values()] == \
        [str(v.dtype) for v in w.values()]


def _refusal(fn) -> str:
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_refusals_match_the_reference_word_for_word(fake_group):
    """Every cell ``supports`` refuses, and the pipeline asked of a
    prefill or on a mesh without ``pod``."""
    refused = [(a, s) for a in all_archs() for s in SHAPES
               if not get_arch(a).supports(SHAPES[s])[0]]
    assert len(refused) >= 8
    for a, s in refused:
        assert _refusal(lambda: specs.build_dryrun(a, s, None)) == \
            _refusal(lambda: jspecs.build_dryrun(a, s, None))
    from jax.sharding import Mesh
    import numpy as np
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    for shape in ("prefill_32k", "train_4k"):
        want = _refusal(lambda: jspecs.build_dryrun(
            "xlstm-125m", shape, jmesh, pipeline=True))
        assert want.startswith("pipeline mode needs")
        assert _refusal(lambda: specs.build_dryrun(
            "xlstm-125m", shape, mesh, pipeline=True)) == want


# -- the (2, 4) mesh: meta, in_specs and counts against the JAX lowering ----

_JAX_CELLS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
jax.devices()
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_arch
from repro.configs.base import ShapeSpec
import repro.launch.specs as S
from repro.launch import hlo_analysis
from repro.launch.dryrun import _arg_bytes_per_device

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): [list(a) if isinstance(a, tuple) else a
                                      for a in s.spec]
            for path, s in leaves}

def flops(spec):
    compiled = jax.jit(spec.step_fn, in_shardings=spec.in_shardings,
                       out_shardings=spec.out_shardings,
                       donate_argnums=spec.donate_argnums).lower(
                           *spec.args).compile()
    return hlo_analysis.analyze(compiled.as_text()).flops

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
out = {}
for arch, kind, b, s, lower in json.loads(sys.argv[1]):
    S.get_arch = lambda a, cfg=get_arch(arch, smoke=True): cfg
    S.SHAPES = {"cell": ShapeSpec("cell", s, b, kind)}
    spec = S.build_dryrun(arch, "cell", mesh)
    rec = {"meta": spec.meta, "donate": list(spec.donate_argnums),
           "in_specs": [flat(t) for t in spec.in_shardings]}
    if lower:
        rec["flops"] = flops(spec)
        rec["arg_bytes"] = _arg_bytes_per_device(spec)
    if kind == "train":
        rec["whole_flops"] = flops(S.build_dryrun(arch, "cell", one))
    out[f"{arch}/{kind}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    cells = [(a, k, B, S, k != "decode") for a in SMOKE_ARCHS for k in KINDS]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_CELLS,
                           json.dumps(cells)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def cell_spec(fake_group, monkeypatch):
    """The port's ``build_dryrun`` for a smoke cell on the (2, 4) mesh."""
    mesh = dryrun.fake_mesh(*MESH)

    def build(arch: str, kind: str):
        cfg = get_arch(arch, smoke=True)
        monkeypatch.setattr(specs, "get_arch", lambda a: cfg)
        monkeypatch.setattr(specs, "SHAPES",
                            {"cell": ShapeSpec("cell", S, B, kind)})
        return specs.build_dryrun(arch, "cell", mesh), mesh

    return build


def _port_flat(tree) -> dict:
    out = {}
    map_with_path(lambda path, s: out.__setitem__(
        path, [list(a) if isinstance(a, tuple) else a for a in s]), tree)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_meta_and_in_specs_equal_the_reference(jax_cells, cell_spec, arch,
                                               kind):
    spec, _ = cell_spec(arch, kind)
    want = jax_cells[f"{arch}/{kind}"]
    assert json.loads(json.dumps(spec.meta)) == want["meta"]
    assert list(spec.donate_argnums) == want["donate"]
    got = [_port_flat(t) for t in spec.in_specs]
    assert [sorted(g) for g in got] == [sorted(w) for w in want["in_specs"]]
    assert got == want["in_specs"]


def _replicated_weight_grad_flops(spec) -> float:
    """ROADMAP.md section 3, finding D1: the most work a device the port's
    train step can repeat beyond the reference's. DTensor computes the
    gradient of a weight its spec leaves whole over ``model`` (a leaf
    ``w*`` or ``r_*`` naming no ``model`` axis), 2 * T * numel FLOPs for T
    tokens a device, on every ``model`` rank; GSPMD can split it at most
    ``model`` ways."""
    sizes = dict(zip(MESH[1], MESH[0]))
    tokens = B * S // sizes["data"]
    shapes, names = {}, _port_flat(spec.in_specs[0].params)
    map_with_path(lambda path, t: shapes.__setitem__(path, t.numel()),
                  spec.args[0].params)
    total = 0
    for path, spec_ in names.items():
        leaf = path.split("/")[-1]
        axes = [a for e in spec_ for a in
                (e if isinstance(e, list) else [e])]
        if leaf.startswith(("w", "r_")) and len(spec_) >= 2 \
                and "model" not in axes:
            total += 2 * tokens * shapes[path]
    return total * (1 - 1 / sizes["model"])


@pytest.mark.parametrize("kind", ("prefill", "train"))
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_counts_a_device_against_the_reference_lowering(jax_cells, cell_spec,
                                                        arch, kind):
    """Argument bytes a device exactly; FLOPs a device within FLOPS_REL of
    the reference's HLO count. The train step's are held on both sides of
    the reference's by what ROADMAP.md section 3 names: above, by the work
    of finding D1 (:func:`_replicated_weight_grad_flops`), which DTensor
    repeats on every ``model`` rank; below, by an even share of the
    reference's whole step on one device (finding D3: the reference's
    lowering does not split each microbatch's tokens over ``data``, so
    its count a device exceeds that share where the port's does not)."""
    spec, mesh = cell_spec(arch, kind)
    counts = dryrun.trace_step(spec, mesh)
    want = jax_cells[f"{arch}/{kind}"]
    assert counts["arg_bytes"] == want["arg_bytes"]
    flops = counts["roof"].flops
    if kind == "prefill":
        assert abs(flops - want["flops"]) <= FLOPS_REL * want["flops"]
    else:
        excess = _replicated_weight_grad_flops(spec)
        share = want["whole_flops"] / mesh.size()
        assert (1 - FLOPS_REL) * share <= flops \
            <= (1 + FLOPS_REL) * (want["flops"] + excess)
        # the old state given up (donated) still leaves the new one
        assert counts["out_bytes"] <= counts["donated_peak"] \
            <= counts["roof"].peak_bytes
    assert counts["roof"].link_bytes > 0 and counts["roof"].peak_bytes > 0


def test_an_op_without_a_sharding_rule_fails_the_cell(fake_group,
                                                      monkeypatch, tmp_path):
    """The cell records the error with the op's name; nothing is
    replicated to get past it."""
    from repro_torch.models.sharding import Spec

    def step(x):
        return torch.renorm(x, 2, 0, 1.0)

    spec = specs.DryRunSpec(step_fn=step,
                            args=(torch.empty(256, 64, device="meta"),),
                            in_specs=(Spec("data", None),), out_specs=None,
                            meta={})
    monkeypatch.setattr(dryrun, "build_dryrun", lambda *a, **k: spec)
    rec = dryrun.run_cell("yi-9b", "decode_32k", "single",
                          out_dir=str(tmp_path))
    assert rec["status"] == "error"
    assert "aten.renorm.default" in rec["error"]
    assert json.loads((tmp_path / "yi-9b_decode_32k_single.json")
                      .read_text())["status"] == "error"


def test_yi9b_decode_cell_end_to_end(fake_group, tmp_path):
    """One full-size cell on the 256-rank mesh through ``run_cell``."""
    rec = dryrun.run_cell("yi-9b", "decode_32k", "single",
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256
    assert json.loads((tmp_path / "yi-9b_decode_32k_single.json")
                      .read_text())["status"] == "ok"
    want = jspecs.model_flops(jax_arch("yi-9b"), JSHAPES["decode_32k"])
    assert rec["model_flops"] == want["model_flops"]
    assert rec["params_total"] == want["params_total"]
    for key in ("op_flops_per_device", "op_bytes_per_device",
                "link_bytes_per_device", "arg_bytes_per_device",
                "compute_s", "memory_s", "collective_s"):
        assert rec[key] > 0, key
    mem = rec["memory_analysis"]
    assert mem["argument_bytes"] == rec["arg_bytes_per_device"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    # no more live than the arguments and every byte the ops wrote
    assert mem["peak_bytes"] <= mem["argument_bytes"] \
        + rec["op_bytes_per_device"]
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["meta"]["cache_batch_replicated"] is False
    assert 0 < rec["useful_ratio"]
