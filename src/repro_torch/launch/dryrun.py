"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
256- or 512-rank mesh. Counterpart of ``repro/launch/dryrun.py``.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch

This is the one entry point of the port that needs no card: where the
reference lowers each step for 512 placeholder host devices, :func:`main`
starts a fake process group of 256 or 512 ranks in this process (this
process is rank 0; a collective completes at once and moves nothing) and
builds the production mesh over it (:func:`fake_mesh`). Every leaf of a
cell's arguments is a ``meta`` tensor cut to rank 0's shard of its
:class:`~repro_torch.models.sharding.Spec` and wrapped as a ``DTensor``;
the step runs on them under :class:`~repro_torch.launch.op_analysis.OpCounter`
and ``CommDebugMode``, plain tensors the step makes (masks, positions)
counting as replicated. Its outputs are then redistributed to the cell's
out specs, as the reference's ``out_shardings``; a result without one has
its pending sums (``Partial`` placements) resolved. A step that is
per-rank code (the pipeline, ``DryRunSpec.manual``) runs on the local
shards themselves.

The step runs under :func:`~repro_torch.launch.dtensor_rules.op_rules`,
which give DTensor a rule for the ops the port's model runs that it has
none for (``aten.view`` where a split dim cannot stay split, as Yi-9B's 4
KV heads over 16 ``model`` ranks; ``log_sigmoid``) and take them away
again after the step. Any other op without a sharding rule fails the cell:
its record reads ``status: "error"`` with the op DTensor was dispatching,
as a failed lowering does in the reference. No leaf is replicated and no
count falls back to the local tensors to get past it.

Per cell the record keeps the reference's keys where their meaning carries
over (``chips``, ``model_flops*``, ``params_total``, ``useful_ratio``,
``compute_s``, ``memory_s``, ``collective_s``, ``dominant``,
``collectives``, ``link_bytes_per_device``, ``arg_bytes_per_device``,
``meta``, ``status``, ``error``, ``total_s``), and names the port's own:

* ``op_flops_per_device``, ``op_bytes_per_device`` and
  ``convert_bytes_per_device``: the analyzer's FLOPs, HBM bytes and cast
  bytes on one rank (the reference's ``hlo_*_per_device``), with
  ``flops_by_dtype``;
* ``collective_calls``: collectives a rank issues, by kind; ``comm_counts``:
  the same seen by ``CommDebugMode``, by op;
* ``ops_per_device``: ATen ops one rank runs (the reference's
  ``hlo_chars`` sized its program);
* ``trace_s``: seconds to build and trace the step (the reference's
  ``lower_s`` and ``compile_s``);
* ``memory_analysis`` (the reference's XLA ``memory_analysis``):
  ``argument_bytes`` (exact, the local shards), ``output_bytes``,
  ``peak_bytes``, the most bytes of live storages during the step,
  arguments included, with the arguments of ``DryRunSpec.donate_argnums``
  given up after the last op that touches each storage, as XLA reuses a
  donated buffer (a train step's old state; a decode step's caches,
  written in place, stay), and ``peak_bytes_without_donation``, the same
  with every argument held to the end, as an eager step holds it.

XLA's ``cost_analysis`` and the while-loop trip counts have no
counterpart; nor has ``--save-hlo``: there is no HLO to save.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import SHAPES, all_archs, get_arch
from ..models import sharding as shd
from . import dtensor_rules as DR
from .mesh import production_layout
from .op_analysis import OpCounter, _nbytes, _tensors
from .specs import build_dryrun, model_flops

aten = torch.ops.aten

def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, its rank
    0 (the counterpart of the reference's placeholder host devices)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(shape: tuple, axes: tuple):
    """A mesh of ``shape`` over a fake group of as many ranks. Its device
    type is the card's, ``"cuda"``, though no tensor is on a card: DTensor
    prices a redistribution by that type's devices a host, and on a
    ``"cpu"`` mesh it replaces each all-to-all by an all-gather."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for size in shape:
        n *= size
    start_fake_group(n)
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


# --------------------------------------------------------------------------
# Trees of arguments and specs
# --------------------------------------------------------------------------

def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (dicts, lists, tuples, dataclasses
    such as ``TrainState``) and its spec tree; a single :class:`Spec` (or
    None) covers a whole subtree."""
    def child(key):
        if specs is None or isinstance(specs, shd.Spec):
            return specs
        return getattr(specs, key) if isinstance(key, str) and \
            dataclasses.is_dataclass(specs) else specs[key]

    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, child(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, child(i))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _zip_map(fn, getattr(tree, f.name),
                                              child(f.name))
                             for f in dataclasses.fields(tree)})
    return fn(tree, specs)


def _resolve(t, spec, mesh):
    """An output leaf redistributed to ``spec``; without one, its pending
    sums resolved (Partial -> Replicate)."""
    if isinstance(t, DTensor) and spec is not None:
        return t.redistribute(mesh, shd.placements(spec, mesh))
    return DR.replicate_partials(t)


def trace_step(spec, mesh) -> dict:
    """Run ``spec``'s step once on rank 0's shards over ``mesh`` under the
    analyzer, with DTensor's rules widened by
    :func:`~repro_torch.launch.dtensor_rules.op_rules`; returns the
    per-device counts of the record."""

    def shard(t, s):
        # a copy, not a view of the global ``meta`` tensor: the live-bytes
        # trace counts each storage whole
        local = shd.local_shard(t, s, mesh).clone()
        if spec.manual:
            return local
        return DTensor.from_local(local, mesh, shd.placements(s, mesh),
                                  run_check=False)

    args = tuple(_zip_map(shard, a, s)
                 for a, s in zip(spec.args, spec.in_specs))
    counter = OpCounter()
    comm = CommDebugMode()
    try:
        with DR.op_rules(), implicit_replication(), comm, counter:
            for i, a in enumerate(args):
                counter.hold(a, donate=i in spec.donate_argnums)
            out = spec.step_fn(*args)
            returned = _tensors(out)
            out_specs = spec.out_specs
            if not isinstance(out, tuple):
                out, out_specs = (out,), (out_specs,)
            out = tuple(_zip_map(lambda t, s: _resolve(t, s, mesh), o, s)
                        for o, s in zip(out, out_specs
                                        or (None,) * len(out)))
    except Exception as exc:
        raise RuntimeError(f"{counter.dtensor_op}: {type(exc).__name__}: "
                           f"{exc}") from exc
    return {"roof": counter.roof,
            "donated_peak": counter.donated_peak(returned),
            "arg_bytes": _nbytes(_tensors(args)),
            "out_bytes": _nbytes(_tensors(out)),
            "comm_counts": {str(k): v for k, v in
                            comm.get_comm_counts().items()}}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             out_dir: str | None = None, overrides: dict | None = None,
             tag: str = "") -> dict:
    t0 = time.time()
    multi = mesh_kind == "multi"
    mesh = fake_mesh(*production_layout(multi_pod=multi))
    chips = mesh.size()
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "chips": chips, "status": "ok", "tag": tag,
                    "overrides": overrides or {}}
    try:
        spec = build_dryrun(arch, shape_name, mesh, **(overrides or {}))
        record["meta"] = spec.meta
        counts = trace_step(spec, mesh)
        roof = counts["roof"]
        mf = model_flops(get_arch(arch), SHAPES[shape_name])
        secs = roof.seconds(chips)
        record.update({
            "trace_s": round(time.time() - t0, 1),
            "memory_analysis": {
                "argument_bytes": counts["arg_bytes"],
                "output_bytes": counts["out_bytes"],
                "peak_bytes": counts["donated_peak"],
                "peak_bytes_without_donation": roof.peak_bytes},
            "op_flops_per_device": roof.flops,
            "flops_by_dtype": roof.flops_by_dtype,
            "op_bytes_per_device": roof.hbm_bytes,
            "convert_bytes_per_device": roof.convert_bytes,
            "link_bytes_per_device": roof.link_bytes,
            "collectives": roof.collectives,
            "collective_calls": roof.collective_calls,
            "comm_counts": counts["comm_counts"],
            "ops_per_device": roof.ops,
            "arg_bytes_per_device": counts["arg_bytes"],
            **secs,
            "dominant": max(secs, key=secs.get),
            "model_flops": mf["model_flops"],
            "model_flops_dense": mf["dense_flops"],
            "model_flops_attn": mf["attn_flops"],
            "params_total": mf["params_total"],
            # useful-compute ratio: MODEL_FLOPS / (op flops across chips)
            "useful_ratio": mf["model_flops"] / max(roof.flops * chips, 1.0),
        })
        print(f"[{arch} x {shape_name} x {mesh_kind}] flops/device "
              f"{roof.flops:.4g}, peak bytes {counts['donated_peak']} "
              f"({roof.peak_bytes} without donation)", flush=True)
    except Exception as exc:                                # noqa: BLE001
        record["status"] = "error"
        record["error"] = f"{type(exc).__name__}: {exc}"
        record["traceback"] = traceback.format_exc()[-2000:]
        print(f"[{arch} x {shape_name} x {mesh_kind}] FAILED: "
              f"{record['error'][:500]}", flush=True)
    record["total_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(
            out_dir, f"{arch}_{shape_name}_{mesh_kind}{suffix}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return record


def main(argv: list | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    # hillclimb overrides (written under --tag so baselines are kept)
    ap.add_argument("--tag", default="")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--zero-grads", action="store_true")
    ap.add_argument("--no-zero", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None)
    args = ap.parse_args(argv)
    overrides: dict = {}
    if args.pipeline:
        overrides["pipeline"] = True
    if args.zero_grads:
        overrides["zero_grads"] = True
    if args.no_zero:
        overrides["zero"] = False
    if args.microbatches is not None:
        overrides["microbatches"] = args.microbatches
    if args.remat is not None:
        overrides["remat"] = args.remat

    archs = all_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    results = []
    for arch in archs:
        cfg = get_arch(arch)
        for shape_name in shapes:
            ok, why = cfg.supports(SHAPES[shape_name])
            if not ok:
                print(f"[{arch} x {shape_name}] SKIP: {why}", flush=True)
                continue
            for mesh_kind in meshes:
                out_json = os.path.join(
                    args.out, f"{arch}_{shape_name}_{mesh_kind}.json")
                if args.skip_existing and os.path.exists(out_json):
                    with open(out_json) as f:
                        prev = json.load(f)
                    if prev.get("status") == "ok":
                        print(f"[{arch} x {shape_name} x {mesh_kind}] "
                              "cached", flush=True)
                        continue
                rec = run_cell(arch, shape_name, mesh_kind,
                               out_dir=args.out, overrides=overrides,
                               tag=args.tag)
                results.append(rec)
                print(f"[{arch} x {shape_name} x {mesh_kind}] "
                      f"{rec['status']} {rec['total_s']}s "
                      f"dominant={rec.get('dominant')}", flush=True)
    bad = [r for r in results if r["status"] != "ok"]
    print(f"\n== dry-run done: {len(results) - len(bad)} ok, "
          f"{len(bad)} failed ==", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
