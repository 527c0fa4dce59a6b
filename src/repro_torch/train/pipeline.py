"""Pipeline parallelism over the ``pod`` mesh axis (GPipe). Counterpart of
``repro/train/pipeline.py``.

Cross-pod links are the slowest hop: data parallelism over pods moves a
full gradient set a step, a pipeline only microbatch activations between
adjacent stages, and it also splits the model's state across pods. Each
rank of the ``pod`` axis holds one stage: ``L / P`` consecutive layers of
the stacked stage (``split_stage_params``, then its own slice, see
:func:`local_stage_params`) and whole copies of the embedding, the final
norm and the unembedding. The ``data`` and ``model`` axes are replicated
within a stage.

The loss runs the reference's GPipe clock of ``M + P - 1`` ticks: at tick t
stage p works on microbatch t - p, stage 0 embedding it, each stage running
its layers and handing the output to the next stage, the last one taking
the masked NLL of the microbatch that arrives. Loss and count are summed
over ``pod``. The hand-offs are autograd functions, so the backward runs
the schedule in reverse, each stage sending its input's gradient back;
:meth:`PipelineLoss.value_and_grad` drives it and sums the replicated
leaves' gradients over ``pod``, which gives every stage the gradients of
the plain ``Model.loss`` for the leaves it holds.

Restrictions, as the reference's: one uniform stage (a repeated unit)
whose repeat divides the pod count; the batch carries tokens and labels
(a frontend's extra inputs are not read); the MoE aux loss is dropped.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from .. import collectives as C
from ..models import layers as L
from ..models.model import Model, _maybe_remat, _norm, block_apply
from ..models.sharding import Spec, shard_tree
from ..optim import adamw
from ..tree import leaves, tree_map
from .state import TrainState


def split_stage_params(params: Any, n_stages: int) -> Any:
    """Reshape the stacked stage's params (L, ...) -> (n_stages,
    L/n_stages, ...). Leaves embed/unembed/norms untouched."""
    if len(params["stages"]) != 1:
        raise ValueError("the pipeline needs a uniform stack (one stage)")

    def resplit(leaf):
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not divide over {n_stages} "
                             f"pipeline stages")
        return leaf.reshape(n_stages, n // n_stages, *leaf.shape[1:])

    out = dict(params)
    out["stages"] = [tree_map(resplit, params["stages"][0])]
    return out


def stage_param_specs(specs: Any) -> Any:
    """Prepend the 'pod' axis to the stage params' layer axis."""
    out = dict(specs)
    out["stages"] = [tree_map(lambda s: Spec("pod", *s),
                              specs["stages"][0])]
    return out


def local_stage_params(params: Any, mesh) -> Any:
    """This rank's parameters for the pipeline on ``mesh``: its stage's
    slice (1, L/P, ...) of the split stack, every other leaf whole (views
    of ``params``)."""
    split = split_stage_params(params, mesh["pod"].size())
    whole = tree_map(lambda t: Spec(*([None] * t.ndim)), params)
    return shard_tree(split, stage_param_specs(whole), mesh)


class _Recv(torch.autograd.Function):
    """Microbatch ``i``'s activations from the previous stage; backward
    sends their gradient back. ``anchor`` (a leaf that requires grad) ties
    the node into the graph, so that backward reaches it."""

    @staticmethod
    def forward(ctx, anchor, pipe, i):
        ctx.pipe, ctx.i = pipe, i
        return pipe.handoff.recv(pipe.boundary, pipe.dtype, pipe.device,
                                 pipe.prev, 2 * i, pipe.group)

    @staticmethod
    def backward(ctx, g):
        ctx.pipe.handoff.send(g, ctx.pipe.prev, 2 * ctx.i + 1, ctx.pipe.group)
        return None, None, None


class _Send(torch.autograd.Function):
    """Microbatch ``i``'s activations to the next stage; returns a 0 that
    joins the loss, whose backward receives their gradient."""

    @staticmethod
    def forward(ctx, x, pipe, i):
        ctx.pipe, ctx.i = pipe, i
        pipe.handoff.send(x, pipe.next, 2 * i, pipe.group)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        p = ctx.pipe
        return (p.handoff.recv(p.boundary, p.dtype, p.device, p.next,
                               2 * ctx.i + 1, p.group), None, None)


class PipelineLoss:
    """``loss_fn(params, batch)`` of :func:`make_pipeline_loss`, on this
    rank's params (:func:`local_stage_params`) and the whole batch. Call
    :meth:`value_and_grad` for gradients: it runs every hand-off of the
    backward (``torch.autograd.grad`` on a subset of leaves would skip
    those of the receives)."""

    def __init__(self, model: Model, mesh, *, microbatches: int,
                 remat: str = "full"):
        cfg = model.cfg
        if len(cfg.stages) != 1:
            raise ValueError("the pipeline needs a uniform stack (one stage)")
        (self.pattern, repeat), = cfg.stages
        self.n_stages = mesh["pod"].size()
        if repeat % self.n_stages:
            raise ValueError(f"{repeat} layers do not divide over "
                             f"{self.n_stages} pipeline stages")
        self.per_stage = repeat // self.n_stages
        self.model, self.microbatches, self.remat = model, microbatches, remat
        self.stage = mesh.get_local_rank("pod")
        self.group = mesh.get_group("pod")
        pod = mesh.mesh_dim_names.index("pod")
        coord = list(mesh.get_coordinate())

        def rank_at(p: int) -> int:
            c = list(coord)
            c[pod] = p
            return int(mesh.mesh[tuple(c)])

        last = self.n_stages - 1
        self.prev = rank_at(self.stage - 1) if self.stage > 0 else None
        self.next = rank_at(self.stage + 1) if self.stage < last else None
        self.handoff = C.HandOff()
        self.reduce_s = 0.0      # summing the replicated leaves' grads

    def _layer(self, x, lp):
        for bi, kind in enumerate(self.pattern):
            x, _, _ = block_apply(lp[f"b{bi}"], x, self.model.cfg, kind,
                                  kernel_impl=self.model.kernel_impl)
        return x

    def _nll(self, params, x, labels):
        cfg = self.model.cfg
        out_table = params["embed"] if cfg.tie_embeddings \
            else params["unembed"]
        h = _norm(cfg, params["final_norm"], x).float()
        logp = torch.log_softmax(L.unembed(out_table, h), -1)
        nll = -logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
        msk = (labels >= 0).float()
        return (nll * msk).sum(), msk.sum()

    def __call__(self, params: Any, batch: dict) -> torch.Tensor:
        m, n, p = self.microbatches, self.n_stages, self.stage
        table = params["embed"]["table"]
        tokens = batch["tokens"]
        mb = tokens.shape[0] // m
        tokens = tokens.reshape(m, mb, *tokens.shape[1:])
        labels = batch["labels"].reshape(m, mb, *batch["labels"].shape[1:])
        self.boundary = (mb, tokens.shape[-1], self.model.cfg.d_model)
        self.dtype, self.device = table.dtype, table.device
        stage = tree_map(lambda t: t[0], params["stages"][0])
        layers = [tree_map(lambda t, r=r: t[r], stage)
                  for r in range(self.per_stage)]
        layer = _maybe_remat(self._layer, self.remat)
        anchor = torch.zeros((), requires_grad=True)
        loss_sum = torch.zeros((), device=self.device)
        count = torch.zeros((), device=self.device)
        links = []
        for t in range(m + n - 1):
            i = t - p                     # the microbatch at this stage now
            if not 0 <= i < m:
                continue
            x = (L.embed(params["embed"], tokens[i]) if p == 0
                 else _Recv.apply(anchor, self, i))
            for lp in layers:
                x = layer(x, lp)
            if p < n - 1:
                links.append(_Send.apply(x, self, i))
            else:
                nll, c = self._nll(params, x, labels[i])
                loss_sum, count = loss_sum + nll, count + c
        total = C.psum(loss_sum, self.group) \
            / C.psum(count, self.group).clamp_min(1.0)
        for link in links:
            total = total + link
        return total

    def value_and_grad(self, params: Any, batch: dict):
        """(loss, grads) on this rank: grads of its stage's layers, and of
        the replicated leaves summed over ``pod``, the same on every
        stage. ``reduce_s`` accumulates the seconds of that sum."""
        leafs = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = self(leafs, batch)
        torch.autograd.backward(loss)
        self.handoff.wait()
        grads = tree_map(lambda t: t.grad if t.grad is not None
                         else torch.zeros_like(t), leafs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for name, sub in grads.items():
            if name != "stages":
                for g in leaves(sub):
                    C.all_reduce_(g, self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reduce_s += time.perf_counter() - t0
        return loss.detach(), grads

    def grad_norm(self, grads: Any) -> torch.Tensor:
        """The global norm over every stage's gradients, the replicated
        leaves counted once."""
        sq = lambda tree: sum(g.float().square().sum()  # noqa: E731
                              for g in leaves(tree))
        staged = C.all_reduce_(sq(grads["stages"]).reshape(1), self.group)
        rest = sq({k: v for k, v in grads.items() if k != "stages"})
        return torch.sqrt(staged[0] + rest)


def make_pipeline_loss(model: Model, mesh, *, microbatches: int,
                       remat: str = "full") -> PipelineLoss:
    """Returns loss_fn(params, batch) running the layer stack as a
    ``pod``-axis pipeline; ``params`` are this rank's
    (:func:`local_stage_params`)."""
    return PipelineLoss(model, mesh, microbatches=microbatches, remat=remat)


def make_pipeline_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                             mesh, *, microbatches: int,
                             remat: str = "full") -> Callable:
    """(state, batch) -> (state, metrics) on this rank's state: AdamW on
    its leaves, clipped by the global norm over all stages."""
    loss_fn = make_pipeline_loss(model, mesh, microbatches=microbatches,
                                 remat=remat)

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        loss, grads = loss_fn.value_and_grad(state.params, batch)
        new_params, new_opt, metrics = adamw.apply_updates(
            opt_cfg, state.params, grads, state.opt,
            grad_norm=loss_fn.grad_norm(grads))
        metrics["loss"] = loss
        return TrainState(new_params, new_opt), metrics

    train_step.loss_fn = loss_fn
    return train_step
