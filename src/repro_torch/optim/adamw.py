"""AdamW with mixed precision, global-norm clipping and a warmup-cosine
schedule. Counterpart of ``repro/optim/adamw.py``.

Plain functions on nested dicts and lists of tensors: params may be bf16;
the first and second moments are fp32; the update is computed in fp32 and
cast back to the param dtype. Every scalar (step, lr, grad norm) stays a
0-d tensor on the params' device, so a step needs no host sync. The
functions build new tensors and leave their inputs as they were, as the
reference's pure functions do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params: Any) -> dict:
    device = next(leaves(params)).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else torch.ones((), device=gnorm.device))
    lr = schedule(cfg, step)

    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:     # decay matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"step": step, "m": _pick(out, 1), "v": _pick(out, 2)}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _pick(tree, i: int):
    """Entry ``i`` of each (p, m, v) tuple at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(t, i) for k, t in tree.items()}
    if isinstance(tree, list):
        return [_pick(t, i) for t in tree]
    return tree[i]
