"""Mixture-of-Experts layer (GShard/Switch-style capacity dispatch) in
PyTorch. Counterpart of ``repro/models/moe.py`` (the auto path,
``moe_apply``).

Covers qwen2-moe (4 shared + 60 routed, top-4) and deepseek-moe (2 shared +
64 fine-grained routed, top-6). Expert weights carry a leading expert axis
of ``e_pad`` experts; the router has ``n_experts`` columns, so the pad
experts are never routed. Routing, dispatch, the expert products and the
combine are functions of their own that :func:`moe_apply` looks up at each
call, so a caller can wrap one to record the decisions or time it. The
reference's expert-parallel ``moe_apply_manual`` comes with the
multi-device substrate.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import Params, _he, mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int           # routed experts
    top_k: int
    d_expert: int            # per-expert FFN width
    n_shared: int = 0        # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # expert-weight padding so the expert axis divides the TP degree
    # (qwen2-moe: 60 -> 64; the pad experts are never routed)
    n_experts_padded: int = 0

    @property
    def e_pad(self) -> int:
        return max(self.n_experts_padded, self.n_experts)


def capacity(dims: MoEDims, s: int) -> int:
    """Slots an expert has in one batch row of ``s`` tokens, the
    reference's expression: prefill at S=512 on qwen2-moe gets 42, a
    decode step (S=1) gets 1."""
    return max(1, int(dims.capacity_factor * s * dims.top_k
                      / dims.n_experts))


def moe_init(gen: torch.Generator, dims: MoEDims, dtype=torch.float32,
             device="cpu") -> Params:
    """Leaves drawn one at a time from ``gen``: the router (d, n_experts)
    in fp32, ``w_gate``/``w_up`` (e_pad, d, f), ``w_down`` (e_pad, f, d),
    and the shared experts as one SwiGLU MLP of width n_shared * f
    (the same function as n_shared parallel experts summed)."""
    dev = torch.device(device)
    d, e, f = dims.d_model, dims.e_pad, dims.d_expert
    s_in, s_out = d ** -0.5, f ** -0.5
    p: Params = {
        "router": _he(gen, (d, dims.n_experts), s_in, torch.float32, dev),
        "w_gate": _he(gen, (e, d, f), s_in, dtype, dev),
        "w_up": _he(gen, (e, d, f), s_in, dtype, dev),
        "w_down": _he(gen, (e, f, d), s_out, dtype, dev),
    }
    if dims.n_shared:
        p["shared"] = mlp_init(gen, d, dims.n_shared * f, "swiglu", dtype,
                               dev)
    return p


class Routing(NamedTuple):
    """One MoE layer's decisions for x (B, S, d), K = top_k."""
    gate_vals: torch.Tensor   # (B,S,K) fp32, renormalised over the top-k
    gate_idx: torch.Tensor    # (B,S,K) int64, by descending probability
    within: torch.Tensor      # (B,S,K) bool: the assignment has a slot
    slot: torch.Tensor        # (B,S,K) int64, clipped to capacity - 1
    capacity: int
    aux: torch.Tensor         # () fp32, the Switch load-balancing loss


def route(router: torch.Tensor, x: torch.Tensor, dims: MoEDims) -> Routing:
    """Router logits in fp32, softmax over the routed experts, the top-k
    sorted and renormalised, the Switch aux loss over ``n_experts``, and
    each assignment's slot: the running count of its expert over the
    flattened (S, K) axis of its batch row, within ``capacity(dims, S)``."""
    b, s, _ = x.shape
    e, k = dims.n_experts, dims.top_k
    cap = capacity(dims, s)
    logits = x.float() @ router                                 # (B,S,E)
    probs = torch.softmax(logits, -1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # aux load-balancing loss (Switch): E * sum_e f_e * P_e
    me = probs.reshape(b * s, e).mean(0)
    ce = F.one_hot(gate_idx[..., 0].reshape(-1), e).float().mean(0)
    aux = dims.router_aux_weight * e * (me * ce).sum()

    onehot = F.one_hot(gate_idx, e)                             # (B,S,K,E)
    cnt = onehot.reshape(b, s * k, e).cumsum(1).reshape(b, s, k, e)
    pos = (cnt * onehot).sum(-1) - 1                            # (B,S,K)
    return Routing(gate_vals, gate_idx, pos < cap, pos.clamp(0, cap - 1),
                   cap, aux)


def _rows(r: Routing) -> torch.Tensor:
    """Each assignment's batch row, (B,S,K)."""
    b, s, k = r.gate_idx.shape
    return torch.arange(b, device=r.gate_idx.device)[:, None, None] \
        .expand(b, s, k)


def dispatch(x: torch.Tensor, r: Routing, e_pad: int) -> torch.Tensor:
    """Each token into an (e_pad, B·C, d) buffer at its (expert, row,
    slot); an assignment beyond its expert's capacity C adds zeros. A slot
    holds at most one real token, so the accumulating scatter is exact in
    any order."""
    b, _, d = x.shape
    contrib = x[:, :, None, :] * r.within[..., None].to(x.dtype)
    buf = x.new_zeros(e_pad, b, r.capacity, d).index_put(
        (r.gate_idx, _rows(r), r.slot), contrib, accumulate=True)
    return buf.reshape(e_pad, b * r.capacity, d)


def experts(p: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over all its slots, as batched matmuls over
    the expert axis: (E, B·C, d) -> (E, B·C, d)."""
    h = F.silu(torch.bmm(expert_in, p["w_gate"])) * \
        torch.bmm(expert_in, p["w_up"])
    return torch.bmm(h, p["w_down"])


def combine(expert_out: torch.Tensor, r: Routing, dtype) -> torch.Tensor:
    """Each token's k slots gathered back and mixed with its gates in fp32
    (a dropped assignment weighs 0): (B, S, d) in ``dtype``."""
    b = r.gate_idx.shape[0]
    out = expert_out.reshape(expert_out.shape[0], b, r.capacity, -1)
    out_tok = out[r.gate_idx, _rows(r), r.slot]                 # (B,S,K,d)
    w = (r.gate_vals * r.within.float())[..., None]
    return (out_tok.float() * w).sum(2).to(dtype)


def moe_apply(p: Params, x: torch.Tensor, dims: MoEDims
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y, aux_loss).

    Tokens are routed (:func:`route`) and scattered into per-row expert
    buffers (:func:`dispatch`); tokens beyond an expert's per-row capacity
    are dropped (their routed contribution is 0; the residual stream and
    the shared experts still carry them). Every expert runs over all its
    slots (:func:`experts`), and each token mixes its k slots back with
    its gates (:func:`combine`); then the shared experts' MLP is added.
    Each part is looked up at each call, so a profiler can wrap it."""
    r = route(p["router"], x, dims)
    y = combine(experts(p, dispatch(x, r, dims.e_pad)), r, x.dtype)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, "swiglu")
    return y, r.aux
