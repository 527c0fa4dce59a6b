"""Multi-rank jobs for the port's multi-device tests, on gloo over the CPU.

Not collected (leading underscore). :func:`run` starts ``world`` rank
processes (``python -c`` with this directory and ``src`` on the path; each
imports torch and ``repro_torch``, never jax), hands them a pickled job
through a work directory, joins a gloo process group on a file store there
and collects each rank's pickled result. A rank that raises or outlives the
timeout fails the call with every rank's output.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run(job: str, world: int, payload: dict, *, timeout: float = 150.0
        ) -> list:
    """Each rank's result of ``JOBS[job](rank, world, payload)``."""
    with tempfile.TemporaryDirectory(prefix="repro-torch-dist-") as work:
        wd = pathlib.Path(work)
        (wd / "job.pkl").write_bytes(pickle.dumps((job, payload)))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), str(ROOT / "tests")]))
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import _torch_dist_harness as h; h._rank_main()",
             str(r), str(world), work],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                left = max(deadline - time.monotonic(), 0.1)
                outs.append(p.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            logs = [p.communicate()[0] for p in procs]
            raise AssertionError(f"{job}: ranks past {timeout} s:\n"
                                 + "\n".join(logs[-2:]))
        results = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            f = wd / f"rank{r}.pkl"
            if p.returncode != 0 or not f.exists():
                raise AssertionError(f"{job}: rank {r} exit {p.returncode}:"
                                     f"\n{out[-4000:]}")
            results.append(pickle.loads(f.read_bytes()))
        return results


def _rank_main() -> None:
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    job, payload = pickle.loads(pathlib.Path(work, "job.pkl").read_bytes())
    if payload.get("device") == "cuda":
        torch.cuda.set_device(0)         # the ranks share the one card
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    try:
        out = JOBS[job](rank, world, payload)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    pathlib.Path(work, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _np(t):
    return t.detach().cpu().numpy()


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


# --------------------------------------------------------------------------
# jobs
# --------------------------------------------------------------------------

def _shard_job(rank, world, payload):
    """Each rank's ``shard_tree`` shards and, for the same specs, DTensor's
    own local shard of ``distribute_tensor`` with ``placements``."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import data_axes
    from repro_torch.models import sharding as shd
    mesh = _mesh(payload["shape"], payload["names"])
    tree = {k: torch.from_numpy(v) for k, v in payload["tree"].items()}
    specs = {k: shd.Spec(*s) for k, s in payload["specs"].items()}
    local = shd.shard_tree(tree, specs, mesh)
    dtensor = {k: distribute_tensor(tree[k], mesh,
                                    shd.placements(specs[k], mesh))
               .to_local() for k in tree}
    return {"coord": tuple(mesh.get_coordinate()),
            "data_axes": data_axes(mesh),
            "local": {k: _np(v) for k, v in local.items()},
            "dtensor": {k: _np(v) for k, v in dtensor.items()}}


def _moe_job(rank, world, payload):
    """``moe_apply_manual`` on a (data, model) mesh: y on this rank's rows,
    aux, and the grads of sum(y^2) + aux summed over ``data`` (the grads of
    the whole batch's loss); then the padded case's y."""
    import torch

    from repro_torch.collectives import all_reduce_
    from repro_torch.models.moe import MoEDims, local_experts, \
        moe_apply_manual
    from repro_torch.tree import tree_map
    mesh = _mesh(payload["mesh"], ("data", "model"))
    d_idx = mesh.get_local_rank("data")
    x = torch.from_numpy(payload["x"])
    rows = x.shape[0] // mesh["data"].size()
    xl = x[d_idx * rows:(d_idx + 1) * rows]
    out = {"coord": tuple(mesh.get_coordinate())}
    for case in ("main", "padded"):
        dims = MoEDims(**payload[case]["dims"])
        full = tree_map(torch.from_numpy, payload[case]["params"])
        p = tree_map(lambda t: t.detach().requires_grad_(True),
                     local_experts(full, dims, mesh))
        y, aux = moe_apply_manual(p, xl, dims, mesh)
        out[case] = {"y": _np(y), "aux": float(aux)}
        if case == "main":
            (y.square().sum() + aux).backward()
            grads = tree_map(lambda t: all_reduce_(t.grad.clone(),
                                                   mesh.get_group("data")),
                             p)
            out[case]["grads"] = tree_map(_np, grads)
    return out


def _pipeline_job(rank, world, payload):
    """The pipelined loss, its grads and one pipelined train step on a
    (pod, data, model) mesh, from the JAX package's parameters."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state
    from repro_torch.train.pipeline import (local_stage_params,
                                            make_pipeline_loss,
                                            make_pipeline_train_step)
    from repro_torch.tree import tree_map
    mesh = _mesh(payload["mesh"], ("pod", "data", "model"))
    cfg = get_arch(payload["arch"], smoke=True)
    model = Model(cfg)
    params = local_stage_params(
        params_from_jax(payload["params"], cfg, device="cpu"), mesh)
    params = tree_map(lambda t: t.clone(), params)
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    out = {"stage": mesh.get_local_rank("pod")}
    for remat in payload["remats"]:
        loss_fn = make_pipeline_loss(model, mesh,
                                     microbatches=payload["microbatches"],
                                     remat=remat)
        loss, grads = loss_fn.value_and_grad(params, batch)
        h = loss_fn.handoff
        out[remat] = {"loss": float(loss), "grads": tree_map(_np, grads),
                      "handoff": (h.sent, h.received, h.host_bytes)}
    step = make_pipeline_train_step(
        model, AdamWConfig(**payload["opt"]), mesh,
        microbatches=payload["microbatches"], remat="none")
    state, metrics = step(init_train_state(params), batch)
    out["step"] = {"params": tree_map(_np, state.params),
                   "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"])}
    return out


def card_moe_params(dims, seed: int):
    """An MoE block's whole parameters drawn on the card from ``seed``."""
    import torch

    from repro_torch.models.moe import moe_init
    return moe_init(torch.Generator(device="cuda").manual_seed(seed), dims,
                    device="cuda")


def card_pipeline_cfg():
    """yi-9b's smoke config widened to a head dim the flash kernel takes
    (64), 4 layers: 2 a stage."""
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("yi-9b", smoke=True), n_layers=4,
                               d_model=256, n_heads=4, n_kv_heads=2,
                               head_dim=64, d_ff=512)


def _moe_card_job(rank, world, payload):
    """``moe_apply_manual`` on a (1, world) mesh on the card, the block
    drawn on the card from a seed, each rank keeping its experts."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.moe import MoEDims, local_experts, \
        moe_apply_manual
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    dims = MoEDims(**payload["dims"])
    p = local_experts(card_moe_params(dims, payload["seed"]), dims, mesh)
    y, aux = moe_apply_manual(p, torch.from_numpy(payload["x"]).cuda(),
                              dims, mesh)
    return {"y": _np(y), "aux": float(aux), "pid": os.getpid()}


def _pipeline_card_job(rank, world, payload):
    """The pipelined loss and grads on a (world, 1, 1) mesh on the card,
    the model drawn on the card from a seed, and the flash launches."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import flash_attention as FK
    from repro_torch.models import Model
    from repro_torch.train.pipeline import (local_stage_params,
                                            make_pipeline_loss)
    from repro_torch.tree import tree_map
    mesh = init_device_mesh("cuda", (world, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    model = Model(card_pipeline_cfg())
    params = model.init(torch.Generator(device="cuda").manual_seed(
        payload["seed"]), device="cuda")
    local = tree_map(lambda t: t.clone(), local_stage_params(params, mesh))
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             payload["batch"].items()}
    loss_fn = make_pipeline_loss(model, mesh,
                                 microbatches=payload["microbatches"],
                                 remat="full")
    before = FK.launches
    loss, grads = loss_fn.value_and_grad(local, batch)
    torch.cuda.synchronize()
    return {"stage": mesh.get_local_rank("pod"), "loss": float(loss),
            "grads": tree_map(_np, grads), "launches": FK.launches - before,
            "handoff": (loss_fn.handoff.sent, loss_fn.handoff.received,
                        loss_fn.handoff.host_bytes), "pid": os.getpid()}


JOBS = {"shard": _shard_job, "moe": _moe_job, "pipeline": _pipeline_job,
        "moe_card": _moe_card_job, "pipeline_card": _pipeline_card_job}
