"""Core model layers in PyTorch: what the xLSTM stack uses of
``repro/models/layers.py``.

Parameters are plain dicts of tensors with the JAX package's names and
layouts, so a JAX pytree converts leaf by leaf (``repro_torch.convert``).
The attention, MLP, RoPE and conv-position layers come with the model
families that use them.
"""

from __future__ import annotations

import torch

Params = dict  # nested dict of tensors


def _he(gen: torch.Generator, shape, scale: float, dtype,
        device: torch.device) -> torch.Tensor:
    """N(0, scale^2) draws from ``gen`` (on the generator's device), moved
    to ``device``. On the meta device only the shape is made."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cpu") -> Params:
    return {"table": _he(gen, (vocab, d), 1.0, dtype, torch.device(device))}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits against the embedding table, computed in fp32."""
    return x.float() @ p["table"].float().T
