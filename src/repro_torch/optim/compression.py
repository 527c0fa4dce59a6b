"""Gradient and payload compression on tensors (counterpart of
``repro/optim/compression.py``).

* :func:`quantize_int8` / :func:`dequantize_int8` — per-tensor symmetric
  int8 with an fp32 scale (4x over fp32, 2x over bf16).
* :class:`ErrorFeedback` — residual accumulation so compression error is
  re-injected next step (EF-SGD; keeps convergence).
* :func:`topk_sparsify` — magnitude top-k with index+value encoding.

The arithmetic is the reference's, in fp32 and in the same order, so the
same input gives the same int8 values, scale and residual bit for bit:
the payload codec (``core/backends/transport.py``) depends on it for its
int8 blobs. Trees are nested dicts, lists and tuples of tensors.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _map(fn: Callable, *trees, is_leaf: Callable = lambda t: False):
    t0 = trees[0]
    if is_leaf(t0):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *xs, is_leaf=is_leaf)
                        for xs in zip(*trees))
    return fn(*trees)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_tree(grads: Any) -> Any:
    return _map(lambda g: quantize_int8(g.float()), grads)


def _is_pair(t) -> bool:
    return isinstance(t, tuple) and len(t) == 2


def dequantize_tree(qtree: Any) -> Any:
    return _map(lambda pair: dequantize_int8(*pair), qtree, is_leaf=_is_pair)


def topk_sparsify(x: torch.Tensor, frac: float = 0.01,
                  ) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """Keep the top-``frac`` magnitude entries. Returns (values, flat_idx,
    original_shape)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    _vals, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx, tuple(x.shape)


def topk_restore(vals: torch.Tensor, idx: torch.Tensor,
                 shape: tuple) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


class ErrorFeedback:
    """Residual error feedback: compress(g + e); e' = (g + e) - decompressed.

    State lives host-side per sender (one tree), applied around the
    compressed exchange.
    """

    def __init__(self):
        self.residual: Any | None = None

    def compress(self, grads: Any) -> tuple[Any, Any]:
        if self.residual is not None:
            grads = _map(lambda g, r: g.float() + r, grads, self.residual)
        else:
            grads = _map(lambda g: g.float(), grads)
        q = quantize_tree(grads)
        deq = dequantize_tree(q)
        self.residual = _map(lambda g, d: g - d, grads, deq)
        return q, deq
