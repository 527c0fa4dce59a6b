"""Core model layers in PyTorch: what the xLSTM, RecurrentGemma and GQA
stacks use of ``repro/models/layers.py`` (norms, embedding, RoPE and
Qwen2-VL's M-RoPE, GQA/MQA attention with qk-norm, a global cache or a
local ring-buffer one, the SwiGLU, squared-ReLU and GELU MLPs, and
HuBERT's conv positional encoding).

Parameters are plain dicts of tensors with the JAX package's names and
layouts, so a JAX pytree converts leaf by leaf (``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..launch import dtensor_rules as DR

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
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e6) -> np.ndarray:
    """Frequencies in float64 numpy, as the JAX package computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """fp32 frequencies on ``device``, copied there once: a copy from host
    memory on every call would stall the host behind the stream."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(
        device=device, dtype=torch.float32)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,D) rotated by the angles ang (B,S,D/2), in fp32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, -1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = _rope_table(x.shape[-1], theta, x.device)          # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple, theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE. positions: (3, B, S), the (t, h, w)
    ids; ``sections`` partitions the half-dim among them, e.g. (16, 24,
    24) for D=128: frequency i turns with the axis whose section holds
    it."""
    freqs = _rope_table(x.shape[-1], theta, x.device)          # (D/2,)
    ang_thw = positions[..., None].float() * freqs             # (3,B,S,D/2)
    axis = _mrope_axis(tuple(sections), x.device)              # (D/2,)
    ang = ang_thw.gather(0, axis.expand(1, *ang_thw.shape[1:]))[0]
    return _rotate(x, ang)


@functools.lru_cache(maxsize=None)
def _mrope_axis(sections: tuple, device: torch.device) -> torch.Tensor:
    """The axis (0, 1, 2 for t, h, w) that drives each frequency, on
    ``device`` once."""
    return torch.from_numpy(np.repeat(np.arange(len(sections)),
                                      sections)).to(device)


# --------------------------------------------------------------------------
# Attention (GQA / MQA / local)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int


def attention_init(gen: torch.Generator, dims: AttnDims, dtype=torch.float32,
                   device="cpu", qk_norm: bool = False) -> Params:
    dev = torch.device(device)
    d, h, kvh, hd = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    s = d ** -0.5
    p = {
        "wq": _he(gen, (d, h * hd), s, dtype, dev),
        "wk": _he(gen, (d, kvh * hd), s, dtype, dev),
        "wv": _he(gen, (d, kvh * hd), s, dtype, dev),
        "wo": _he(gen, (h * hd, d), (h * hd) ** -0.5, dtype, dev),
    }
    if qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, dev)
        p["k_norm"] = rmsnorm_init(hd, dtype, dev)
    return p


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, window: "int | None" = None,
         kv_len: "torch.Tensor | None" = None) -> torch.Tensor:
    """Grouped softmax attention, the plain masked path of the JAX package
    (the model itself goes through ``ops``). q: (B,Sq,H,D), k/v:
    (B,Skv,KV,D) with H = KV * G; KV heads are never repeated. Key j is
    visible to query i iff j <= i (causal) and j > i - window; ``kv_len``:
    optional (B,) active cache lengths. Masked logits are -1e30, fp32
    softmax."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) * (d ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, -1e30)
    if kv_len is not None:
        valid = kpos[None] < kv_len[:, None, None]              # (B,1,Skv)
        logits = logits.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(logits, -1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def attention_apply(p: Params, x: torch.Tensor, dims: AttnDims, *,
                    positions: "torch.Tensor | None" = None,
                    rope_kind: str = "rope",
                    mrope_sections: tuple = (16, 24, 24),
                    rope_theta: float = 1e6, causal: bool = True,
                    window: "int | None" = None,
                    cache: "Params | None" = None,
                    norm_eps: float = 1e-6,
                    kernel_impl: str = "hopper",
                    ) -> tuple[torch.Tensor, "Params | None"]:
    """Full attention block: projections, qk-norm when the params have it,
    RoPE or M-RoPE, attention, output projection.

    Without a cache, the whole sequence goes through
    ``ops.flash_attention``, rotated at ``positions`` ((B,S), or (3,B,S)
    for M-RoPE; by default 0..S-1 on every axis). With one, x is (B, 1, d)
    and the cache is {"k": (B,Smax,KV,D), "v": ..., "pos": (B,) int32}: the
    token is rotated at ``pos`` (on all three M-RoPE axes), its key and
    value are written in place at slot ``pos % Smax`` of a local cache
    (``window`` set: a ring buffer, which the softmax does not mind) or at
    slot ``pos`` of a global one, where a write at ``pos >= Smax`` is
    dropped, as JAX's scatter drops it; then the token attends through
    ``ops.decode_attention`` to the first ``min(pos + 1, Smax)`` slots.
    Returns (out, new_cache)."""
    b, s, _ = x.shape
    h, kvh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kvh, hd)
    v = (x @ p["wv"]).reshape(b, s, kvh, hd)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, norm_eps)
        k = rmsnorm(p["k_norm"], k, norm_eps)

    def rotate(t, pos):
        if rope_kind == "rope":
            return apply_rope(t, pos, rope_theta)
        if rope_kind == "mrope":
            if pos.dim() == 2:                   # text positions: all axes
                pos = pos.expand(3, *pos.shape)
            return apply_mrope(t, pos, mrope_sections, rope_theta)
        return t

    if cache is not None:
        pos = cache["pos"]                                       # (B,)
        q, k = rotate(q, pos[:, None]), rotate(k, pos[:, None])
        ck, cv = cache["k"], cache["v"]
        smax = ck.shape[1]
        k_new, v_new = k.to(ck.dtype), v.to(cv.dtype)          # (B,1,KV,D)
        slot = (pos % smax if window is not None
                else pos.clamp(max=smax - 1)).long()
        # a gather and a scatter along the sequence dim, so that a cache
        # sharded on its batch and head dims (DTensor) stays sharded
        idx = slot[:, None, None, None].expand(k_new.shape)
        if window is None:
            # past the end the slot's old contents are written back, so
            # nothing changes and pos never leaves the device
            keep = (pos >= smax)[:, None, None, None]
            k_new = torch.where(keep, ck.gather(1, idx), k_new)
            v_new = torch.where(keep, cv.gather(1, idx), v_new)
        ck.scatter_(1, idx, k_new)                               # in place
        cv.scatter_(1, idx, v_new)
        lengths = torch.clamp(pos + 1, max=smax).to(torch.int32)
        # q in its own type: the kernel widens it and returns that type
        out = ops.decode_attention(q[:, 0], ck, cv, lengths,
                                   kernel_impl=kernel_impl)
        out = out.to(x.dtype)[:, None]                           # (B,1,H,D)
        new_cache = {"k": ck, "v": cv, "pos": pos + 1}
    else:
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q, k = rotate(q, positions), rotate(k, positions)
        if kvh > 1:
            q, k, v = (DR.whole_heads(t) for t in (q, k, v))
        # (B,H,S,D) views of the (B,S,H,D) projections; the output keeps
        # that layout, so the reshape below is free
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window,
                                  kernel_impl=kernel_impl).transpose(1, 2)
        if kvh > 1:
            out = DR.whole_heads_grad(out)
        new_cache = None
    out = out.reshape(b, s, h * hd)
    return out @ p["wo"], new_cache


def attention_cache_init(batch: int, max_seq: int, dims: AttnDims,
                         dtype=torch.bfloat16, device="cpu") -> Params:
    shape = (batch, max_seq, dims.n_kv_heads, dims.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

_MLP_KINDS = ("swiglu", "squared_relu", "gelu")


def _mlp_kind(kind: str) -> None:
    if kind not in _MLP_KINDS:
        raise ValueError(f"unknown mlp kind {kind!r}")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` as the JAX package calls it: its default is the tanh
    approximation, which differs from the exact (erf) GELU by up to ~5e-4
    an element."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, d: int, d_ff: int, kind: str,
             dtype=torch.float32, device="cpu") -> Params:
    _mlp_kind(kind)
    dev = torch.device(device)
    s_in, s_out = d ** -0.5, d_ff ** -0.5
    if kind == "swiglu":
        return {"w_gate": _he(gen, (d, d_ff), s_in, dtype, dev),
                "w_up": _he(gen, (d, d_ff), s_in, dtype, dev),
                "w_down": _he(gen, (d_ff, d), s_out, dtype, dev)}
    return {"w_up": _he(gen, (d, d_ff), s_in, dtype, dev),
            "w_down": _he(gen, (d_ff, d), s_out, dtype, dev)}


def mlp_apply(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """SwiGLU; Nemotron-4's squared ReLU, relu(x w_up)^2 w_down; or
    HuBERT's gelu(x w_up) w_down (tanh GELU, :func:`gelu`). The last two
    have no gate."""
    _mlp_kind(kind)
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "squared_relu":
        h = torch.relu(x @ p["w_up"]) ** 2
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cpu") -> Params:
    return {"table": _he(gen, (vocab, d), 1.0, dtype, torch.device(device))}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``, a negative id counting from the end
    as in the reference (on DTensors: ``dtensor_rules.lookup``)."""
    return DR.lookup(p["table"], tokens)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits against the embedding table, computed in fp32."""
    return x.float() @ p["table"].float().T


# --------------------------------------------------------------------------
# Conv positional encoding (HuBERT-style): a grouped conv over time
# --------------------------------------------------------------------------

def convpos_init(gen: torch.Generator, d: int, kernel: int = 128,
                 groups: int = 16, dtype=torch.float32,
                 device="cpu") -> Params:
    """JAX's leaves: ``w`` (kernel, d / groups, d), the conv's WIO layout,
    and ``b`` (d)."""
    dev = torch.device(device)
    per = d // groups
    return {"w": _he(gen, (kernel, per, d), (kernel * per) ** -0.5, dtype,
                     dev),
            "b": torch.zeros(d, dtype=dtype, device=dev)}


def convpos_apply(p: Params, x: torch.Tensor, groups: int = 16
                  ) -> torch.Tensor:
    """gelu(conv(x) + b) over time for x (B, S, d), S frames out. The
    reference pads (kernel // 2, kernel // 2 - 1 + kernel % 2) frames,
    (64, 63) at kernel 128: ``padding="same"`` would put the odd frame on
    the other side and shift the output by one frame, so the pad is
    explicit. The conv is a library call, as it is an XLA op in the
    reference, summed in fp32 and rounded to x's type once, as XLA sums a
    bf16 conv: PyTorch's CPU conv on bf16 tensors with a 128-tap kernel
    and few channels a group returns sums off by more than their size."""
    kernel = p["w"].shape[0]
    left = kernel // 2
    xt = F.pad(x.transpose(1, 2).float(), (left, left - 1 + kernel % 2))
    y = F.conv1d(xt, p["w"].permute(2, 1, 0).float(), groups=groups)
    return gelu(y.transpose(1, 2).to(x.dtype) + p["b"])
