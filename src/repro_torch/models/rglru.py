"""Griffin/RecurrentGemma recurrent block in PyTorch: conv1d + RG-LRU gated
recurrence. Counterpart of ``repro/models/rglru.py``.

RG-LRU (Real-Gated Linear Recurrent Unit, De et al. 2024):

    r_t = sigmoid(W_a x_t + b_a)             recurrence gate
    i_t = sigmoid(W_x x_t + b_x)             input gate
    a_t = a^(c * r_t)          with a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence runs through ``ops.rglru_scan`` both for a full sequence
(h0 = 0) and for a decode step (S = 1, h0 from the cache): the CUDA kernel
on a CUDA tensor, whose gate algebra is fused in, and the plain log-depth
scan otherwise.

Weights keep JAX's ``(in, out)`` layout (``x @ w``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import Params, _he

__all__ = ["RGLRUDims", "rglru_block_init", "rglru_block_apply",
           "rglru_cache_init"]


@dataclasses.dataclass(frozen=True)
class RGLRUDims:
    d_model: int
    lru_width: int
    conv_width: int = 4


def rglru_block_init(gen: torch.Generator, dims: RGLRUDims,
                     dtype=torch.float32, device="cpu") -> Params:
    dev = torch.device(device)
    d, w = dims.d_model, dims.lru_width
    s = d ** -0.5
    f32 = torch.float32
    # Lambda init so that a = sigmoid(Lambda) in [0.9, 0.999] (paper init)
    if dev.type == "meta":
        lam = torch.empty(w, dtype=f32, device=dev)
    else:
        u = torch.rand(w, generator=gen, device=gen.device) * 0.099 + 0.9
        lam = torch.log(u / (1 - u)).to(device=dev, dtype=f32)
    return {
        "w_in": _he(gen, (d, w), s, dtype, dev),            # x branch
        "w_gate_in": _he(gen, (d, w), s, dtype, dev),       # gate branch
        "conv_w": _he(gen, (dims.conv_width, w), dims.conv_width ** -0.5,
                      dtype, dev),
        "conv_b": torch.zeros(w, dtype=dtype, device=dev),
        "lambda": lam,
        "w_a": _he(gen, (w, w), w ** -0.5, dtype, dev),
        "b_a": torch.zeros(w, dtype=f32, device=dev),
        "w_x": _he(gen, (w, w), w ** -0.5, dtype, dev),
        "b_x": torch.zeros(w, dtype=f32, device=dev),
        "w_out": _he(gen, (w, d), w ** -0.5, dtype, dev),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: "torch.Tensor | None" = None,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,S,W); w: (K,W); state: (B,K-1,W)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)                              # (B,S+K-1,W)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return out, new_state


def rglru_block_apply(p: Params, x: torch.Tensor, dims: RGLRUDims, *,
                      cache: "Params | None" = None,
                      kernel_impl: str = "hopper",
                      ) -> tuple[torch.Tensor, "Params | None"]:
    """Full recurrent temporal-mixing block (Griffin): two input branches
    -> (gate: GeLU) x (main: conv -> RG-LRU) -> out. ``jax.nn.gelu``
    defaults to the tanh approximation, and so does this block."""
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    u = x @ p["w_in"]

    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv1d(u, p["conv_w"], p["conv_b"], conv_state)

    uf = u.float()
    a_gate = torch.sigmoid(uf @ p["w_a"].float() + p["b_a"])
    i_gate = torch.sigmoid(uf @ p["w_x"].float() + p["b_x"])

    h0 = cache["h"].float() if cache is not None else None
    y, h_last = ops.rglru_scan(uf, a_gate, i_gate, p["lambda"], h0,
                               kernel_impl=kernel_impl)
    y = y.to(x.dtype) * gate
    out = y @ p["w_out"]
    new_cache = None
    if cache is not None:
        new_cache = {"h": h_last.to(cache["h"].dtype),
                     "conv": new_conv.to(cache["conv"].dtype)}
    return out, new_cache


def rglru_cache_init(batch: int, dims: RGLRUDims, dtype=torch.float32,
                     device="cpu") -> Params:
    return {"h": torch.zeros(batch, dims.lru_width, dtype=dtype,
                             device=device),
            "conv": torch.zeros(batch, dims.conv_width - 1, dims.lru_width,
                                dtype=dtype, device=device)}
