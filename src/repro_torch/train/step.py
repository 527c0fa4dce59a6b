"""train_step / eval_step / serve_step / prefill_step builders.
Counterpart of ``repro/train/step.py``.

``make_train_step`` returns a (state, batch) -> (state, metrics) function
with gradient accumulation over microbatches; the remat policy is set on
the Model. Metrics stay 0-d tensors on the device: reading one is the
caller's host sync. ``make_serve_step`` performs one greedy decode step for
a whole request batch against the recurrent cache; ``make_prefill_step``
runs the full forward over a prompt and returns the greedy token after it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..launch import dtensor_rules as DR
from ..models.model import Model
from ..optim import adamw
from ..tree import leaves, tree_map
from .state import TrainState


def value_and_grad(model: Model, params, batch: dict):
    """(loss, metrics), grads of ``model.loss`` at ``params``, leaving
    ``params`` as they were. A leaf the loss does not read (HuBERT's
    embedding table) gets zeros, as ``jax.grad`` gives it."""
    leafs = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss(leafs, batch)
    grads = torch.autograd.grad(loss, list(leaves(leafs)), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    grads = tree_map(lambda _: next(it), leafs)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def _split(x: torch.Tensor, microbatches: int) -> torch.Tensor:
    """(B, ...) -> (M, B/M, ...); M-RoPE positions (3, B, S) are split on
    axis 1, to (M, 3, B/M, S)."""
    if x.ndim == 3 and x.shape[0] == 3:
        return x.reshape(3, microbatches, -1, *x.shape[2:]).transpose(0, 1)
    return x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *,
                    microbatches: int = 1,
                    grad_specs: Any = None) -> Callable:
    """With ``microbatches`` > 1 the batch is split on axis 0, the grads
    are summed in fp32 and divided, and the metrics are the mean loss as
    ``ce`` with ``aux`` 0, as in the reference. ``grad_specs``: an optional
    :class:`~repro_torch.models.sharding.Spec` tree the gradients (DTensors)
    are redistributed to on their mesh, the reference's sharding constraint
    (ZeRO-1: grads reduce-scattered onto the optimizer-state sharding)."""

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(model, state.params,
                                                     batch)
            grads = DR.constrain(grads, grad_specs)
        else:
            micro = {k: DR.microbatches(x, microbatches, _split)
                     for k, x in batch.items()}
            grads = DR.constrain(tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32),
                state.params), grad_specs)
            loss = torch.zeros((), device=next(leaves(grads)).device)
            for i in range(microbatches):
                (l_i, _), g_i = value_and_grad(
                    model, state.params, {k: x[i] for k, x in micro.items()})
                grads = tree_map(lambda a, g: a + g.to(torch.float32),
                                 grads, DR.constrain(g_i, grad_specs))
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}

        new_params, new_opt, opt_metrics = adamw.apply_updates(
            opt_cfg, state.params, grads, state.opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_eval_step(model: Model) -> Callable:

    @torch.no_grad()
    def eval_step(params, batch) -> dict:
        loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_serve_step(model: Model) -> Callable:
    """One decode step for a batch of requests: greedy argmax sampling.
    (params, cache, tokens (B,1)) -> (next tokens (B,1) int32, cache)."""

    @torch.no_grad()
    def serve_step(params, cache: Any, tokens: torch.Tensor
                   ) -> tuple[torch.Tensor, Any]:
        logits, new_cache = model.decode_step(params, cache, tokens)
        next_tokens = logits[:, -1:].argmax(-1).to(torch.int32)
        return next_tokens, new_cache

    return serve_step


def make_prefill_step(model: Model) -> Callable:
    """Prefill: full forward over the prompt; the logits of the last
    position give the first generated token, (B,1) int32."""

    @torch.no_grad()
    def prefill_step(params, batch: dict) -> torch.Tensor:
        logits, _ = model.apply(params, batch)
        return logits[:, -1:].argmax(-1).to(torch.int32)

    return prefill_step
