"""Dry-run builders: ``meta`` inputs and partition specs per (arch, shape).
Counterpart of ``repro/launch/specs.py``.

:func:`batch_struct` gives stand-ins for every model input on the ``meta``
device (shapes and types, no memory); :func:`build_dryrun` returns the
port's step function with its ``meta`` arguments and the :class:`Spec`
trees they are sharded by on a mesh, ready for
``repro_torch.launch.dryrun.run_cell``. :func:`param_counts` and
:func:`model_flops` are the analytic yardstick of useful work.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from ..configs.base import SHAPES, ArchConfig, ShapeSpec, get_arch
from ..models import sharding as shd
from ..models.model import Model
from ..optim.adamw import AdamWConfig
from ..train.state import TrainState, init_train_state, train_state_specs
from ..train.step import make_prefill_step, make_serve_step, make_train_step
from ..tree import map_with_path, tree_map
from .mesh import data_axes

# gradient-accumulation defaults so train_4k activations fit HBM
MICROBATCHES = {
    "nemotron-4-340b": 8,   # nem-4: mb=8 beats 16 (see EXPERIMENTS §Perf)
    "qwen2-vl-72b": 8,
    "yi-34b": 4,
    "yi-9b": 2,
    "recurrentgemma-9b": 2,
    "minicpm3-4b": 2,
    "hubert-xlarge": 2,
}

REMAT = {
    "nemotron-4-340b": "full",
    "qwen2-vl-72b": "full",
    "yi-34b": "full",
    "yi-9b": "full",
    "recurrentgemma-9b": "full",
    "minicpm3-4b": "full",
    "hubert-xlarge": "full",
    "qwen2-moe-a2.7b": "dots",
    "deepseek-moe-16b": "dots",
    "xlstm-125m": "none",
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def batch_struct(cfg: ArchConfig, batch: int, seq: int,
                 dtype=torch.bfloat16) -> dict:
    out: dict = {}
    if cfg.frontend == "audio":
        out["frames"] = _meta((batch, seq, cfg.frontend_dim), dtype)
    else:
        out["tokens"] = _meta((batch, seq), torch.int32)
    out["labels"] = _meta((batch, seq), torch.int32)
    if cfg.rope_kind == "mrope":
        out["positions"] = _meta((3, batch, seq), torch.int32)
        out["vision_embeds"] = _meta((batch, min(64, seq), cfg.d_model),
                                     dtype)
    return out


@dataclasses.dataclass
class DryRunSpec:
    """A cell's step and its ``meta`` arguments. ``in_specs`` has one
    :class:`Spec` tree an argument; ``out_specs`` one a result (None: the
    result's sharding is left as the step made it, every pending sum
    resolved), as the reference's ``in_shardings``/``out_shardings``.
    ``donate_argnums`` are the reference's: PyTorch has no buffer
    donation (the train step builds a new state beside the old one, the
    serve step writes the caches in place), so the dry run's peak gives
    each donated argument up after its last use
    (``OpCounter.donated_peak``). ``manual`` marks a step that
    is per-rank code (the GPipe pipeline, as the reference's
    ``shard_map``): it takes each rank's local shards, not DTensors."""
    step_fn: Callable
    args: tuple                 # meta trees
    in_specs: tuple
    out_specs: Any
    meta: dict
    donate_argnums: tuple = ()
    manual: bool = False


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _shapes(cfg: ArchConfig, dtype) -> Any:
    """The full parameter tree on ``meta``: every expert whole, as the
    reference's ``eval_shape`` gives it."""
    return Model(cfg).init(torch.Generator(), device="meta", dtype=dtype)


def build_dryrun(arch: str, shape_name: str, mesh, *,
                 microbatches: int | None = None,
                 remat: str | None = None,
                 zero: bool = True,
                 zero_grads: bool = False,
                 pipeline: bool = False,
                 param_dtype=torch.bfloat16) -> DryRunSpec:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = cfg.supports(shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} skipped: {why}")

    remat = remat if remat is not None else REMAT.get(arch, "none")
    # the dry run counts the plain path, as the reference's HLO counts its
    # jnp path (its models never call a Pallas kernel)
    model = Model(cfg, kernel_impl="plain",
                  remat=remat if shape.kind == "train" else "none",
                  mesh=mesh)
    dp = data_axes(mesh)
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp_size = 1
    for a in dp:
        dp_size *= axis_sizes[a]

    params_shape = _shapes(cfg, param_dtype)
    pspecs = shd.param_specs(params_shape, axis_sizes)

    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "remat": remat, "mesh": axis_sizes,
            "param_dtype": _dtype_name(param_dtype)}

    if pipeline:
        if shape.kind != "train" or "pod" not in axis_sizes:
            raise ValueError("pipeline mode needs a train shape and a "
                             "multi-pod mesh")
        return _build_pipeline_dryrun(cfg, shape, mesh, model, arch,
                                      microbatches, meta, params_shape)

    if shape.kind == "train":
        mb = microbatches if microbatches is not None \
            else MICROBATCHES.get(arch, 1)
        meta["microbatches"] = mb
        meta["zero_grads"] = zero_grads
        state_shape = init_train_state(params_shape)
        state_specs = train_state_specs(params_shape, zero=zero,
                                        axis_sizes=axis_sizes)
        gspecs = state_specs.opt["m"] if zero_grads else None
        step = make_train_step(model, AdamWConfig(), microbatches=mb,
                               grad_specs=gspecs)
        batch_shape = batch_struct(cfg, shape.global_batch, shape.seq_len)
        batch_specs = shd.batch_specs(batch_shape, batch_axes=dp,
                                      axis_sizes=axis_sizes)
        return DryRunSpec(
            step_fn=step,
            args=(state_shape, batch_shape),
            in_specs=(state_specs, batch_specs),
            out_specs=(state_specs, None),
            meta=meta,
            donate_argnums=(0,))

    if shape.kind == "prefill":
        batch_shape = batch_struct(cfg, shape.global_batch, shape.seq_len)
        return DryRunSpec(
            step_fn=make_prefill_step(model),
            args=(params_shape, batch_shape),
            in_specs=(pspecs, shd.batch_specs(
                batch_shape, batch_axes=dp, axis_sizes=axis_sizes)),
            out_specs=None,
            meta=meta)

    # decode / long_decode: one new token against a seq_len cache
    b = shape.global_batch
    cache_shape = model.init_cache(b, shape.seq_len, device="meta",
                                   dtype=torch.bfloat16)
    batch_replicated = b < dp_size
    meta["cache_batch_replicated"] = batch_replicated
    cache_specs = shd.cache_specs(
        cache_shape, batch_axes=dp, batch_replicated=batch_replicated,
        axis_sizes=axis_sizes)
    tok_spec = shd.Spec(None, None) if batch_replicated else \
        shd.Spec(dp if len(dp) > 1 else dp[0], None)
    return DryRunSpec(
        step_fn=make_serve_step(model),
        args=(params_shape, cache_shape, _meta((b, 1), torch.int32)),
        in_specs=(pspecs, cache_specs, tok_spec),
        out_specs=(tok_spec, cache_specs),
        meta=meta,
        donate_argnums=(1,))


def _build_pipeline_dryrun(cfg, shape, mesh, model, arch, microbatches,
                           meta, params_shape) -> DryRunSpec:
    """Train-step dry run with GPipe over the pod axis. The port's pipeline
    holds each stage's layers on its ``pod`` rank and every other leaf,
    and the batch, whole on each rank of a stage (``train/pipeline.py``):
    its specs name ``pod`` alone, where the reference's add the ``data``
    and ``model`` axes of ``param_specs`` inside a stage."""
    from ..train.pipeline import (make_pipeline_train_step,
                                  split_stage_params, stage_param_specs)
    n_stages = mesh["pod"].size()
    mb = microbatches if microbatches is not None \
        else max(MICROBATCHES.get(arch, 1), 2 * n_stages)
    meta["microbatches"] = mb
    meta["pipeline_stages"] = n_stages
    split = split_stage_params(params_shape, n_stages)
    whole = tree_map(lambda t: shd.Spec(*([None] * t.ndim)), params_shape)
    pspecs = stage_param_specs(whole)
    state_shape = init_train_state(split)
    state_specs = TrainState(params=pspecs,
                             opt={"step": shd.Spec(), "m": pspecs,
                                  "v": pspecs})
    batch_shape = batch_struct(cfg, shape.global_batch, shape.seq_len)
    batch_specs = tree_map(lambda t: shd.Spec(*([None] * t.ndim)),
                           batch_shape)
    step = make_pipeline_train_step(model, AdamWConfig(), mesh,
                                    microbatches=mb,
                                    remat=meta.get("remat", "full"))
    return DryRunSpec(
        step_fn=step,
        args=(state_shape, batch_shape),
        in_specs=(state_specs, batch_specs),
        out_specs=(state_specs, None),
        meta=meta,
        donate_argnums=(0,),
        manual=True)


# --------------------------------------------------------------------------
# Analytic model FLOPs (the "useful work" yardstick of the roofline)
# --------------------------------------------------------------------------

def param_counts(cfg: ArchConfig) -> dict:
    """Analytic parameter counts: total, embedding, routed-experts (of the
    tree on ``meta``, once a config)."""
    return dict(_param_counts(cfg))


@functools.lru_cache(maxsize=None)
def _param_counts(cfg: ArchConfig) -> dict:
    counts = {"total": 0, "embedding": 0, "routed": 0}

    def visit(path: str, leaf: torch.Tensor) -> None:
        names = [k for k in path.split("/") if not k.isdigit()]
        n = leaf.numel()
        counts["total"] += n
        if "embed" in names or "unembed" in names:
            counts["embedding"] += n
        if "moe" in names and "shared" not in names and \
                names[-1] in ("w_gate", "w_up", "w_down"):
            counts["routed"] += n

    map_with_path(visit, _shapes(cfg, torch.bfloat16))
    return counts


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active non-emb
    params (MoE: shared + top_k/E of routed), plus the attention term the
    6ND rule ignores (dominant at 32k)."""
    pc = param_counts(cfg)
    n_active = pc["total"] - pc["embedding"] - pc["routed"]
    if cfg.moe is not None and pc["routed"]:
        n_active += pc["routed"] * cfg.moe.top_k / cfg.moe.n_experts
    # unembedding matmul is real compute: count it as params too
    n_active += pc["embedding"] / (2 if not cfg.tie_embeddings else 1)

    tokens = shape.global_batch * (1 if shape.kind in ("decode",
                                                       "long_decode")
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    dense = mult * n_active * tokens

    # attention matmuls: 2 matmuls of (S x ctx x d_attn) each, causal ~ /2
    d_attn = cfg.n_heads * cfg.head_dim
    attn_layers = sum(1 for k in cfg.layer_pattern
                      if k in ("attn", "moe", "dense", "mla"))
    lattn_layers = sum(1 for k in cfg.layer_pattern if k == "lattn")
    if shape.kind in ("decode", "long_decode"):
        ctx = shape.seq_len
        per_tok = 2 * 2 * d_attn * (
            attn_layers * ctx
            + lattn_layers * min(ctx, cfg.attn_window or ctx))
        attn = (mult / 2) * shape.global_batch * per_tok
    else:
        s = shape.seq_len
        causal_frac = 0.5 if cfg.causal else 1.0
        attn = (mult / 2) * shape.global_batch * 2 * 2 * d_attn * (
            attn_layers * s * s * causal_frac
            + lattn_layers * s * min(s, cfg.attn_window or s))
    return {"n_active": n_active, "dense_flops": dense,
            "attn_flops": attn, "model_flops": dense + attn,
            "params_total": pc["total"]}
