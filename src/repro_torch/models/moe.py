"""Mixture-of-Experts layer (GShard/Switch-style capacity dispatch) in
PyTorch. Counterpart of ``repro/models/moe.py`` (the auto path,
``moe_apply``).

Covers qwen2-moe (4 shared + 60 routed, top-4) and deepseek-moe (2 shared +
64 fine-grained routed, top-6). Expert weights carry a leading expert axis
of ``e_pad`` experts; the router has ``n_experts`` columns, so the pad
experts are never routed. Routing, dispatch, the expert products and the
combine are functions of their own that :func:`moe_apply` looks up at each
call, so a caller can wrap one to record the decisions or time it.
:func:`moe_apply_manual` is the reference's expert-parallel path: each rank
of the mesh's ``model`` axis holds only its own experts and the outputs are
summed over the axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .. import collectives as C
from ..launch import dtensor_rules as DR
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


# --------------------------------------------------------------------------
# Manual expert parallelism over the mesh's ``model`` axis
# --------------------------------------------------------------------------

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def experts_per_rank(dims: MoEDims, mesh) -> int:
    """``e_pad / tp``, the experts each ``model`` rank holds."""
    tp = mesh["model"].size()
    if dims.e_pad % tp:
        raise ValueError(f"{dims.e_pad} experts do not divide over "
                         f"model={tp}: pad them (n_experts_padded)")
    return dims.e_pad // tp


def local_experts(p: Params, dims: MoEDims, mesh) -> Params:
    """``p`` (one MoE block's leaves) with the expert leaves cut to this
    rank's ``e_pad / tp`` experts, each a copy, so the rest can be
    freed."""
    epp = experts_per_rank(dims, mesh)
    r = mesh.get_local_rank("model")
    return {k: (v[r * epp:(r + 1) * epp].clone()
                if k in EXPERT_LEAVES else v) for k, v in p.items()}


def moe_apply_manual(p: Params, x: torch.Tensor, dims: MoEDims, mesh, *,
                     dp_axis: str = "data",
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with explicit communication. ``p`` holds this
    rank's experts only (``local_experts``); ``x`` (B_loc, S, d) is this
    ``data`` rank's rows, the same on every ``model`` rank.

    Every ``model`` rank routes all its local tokens (the routing is the
    same on each), scatters the assignments to its own experts into an
    (e_pad / tp, C, d) buffer, runs them and mixes their outputs back with
    the gates; the partial outputs are summed over ``model``. The capacity
    C = cf * B_loc * S * k / E counts the rank's tokens together, with the
    slots taken in order over the flattened (B_loc * S, k) assignments (so
    :func:`route` runs on the tokens as one row). ``aux`` is averaged over
    ``dp_axis``. The experts run in ``x``'s type, the gate mix and the sum
    in fp32, as in the reference; ``y`` returns in ``x``'s type.

    On DTensors it runs on each rank's local shards
    (``dtensor_rules.moe_apply_manual``)."""
    if isinstance(x, DTensor):
        return DR.moe_apply_manual(p, x, dims, mesh, dp_axis=dp_axis)
    b, s, d = x.shape
    epp = experts_per_rank(dims, mesh)
    m_idx = mesh.get_local_rank("model")
    mp = mesh.get_group("model")
    r = route(p["router"], x.reshape(1, b * s, d), dims)
    aux = C.pmean(r.aux, mesh.get_group(dp_axis))

    # the assignments that belong to this rank's experts; the gates and
    # the tokens enter its partial sum through pcopy, so their gradients
    # gather every rank's share
    local_e = r.gate_idx - m_idx * epp
    mine = (local_e >= 0) & (local_e < epp) & r.within
    r_loc = r._replace(gate_idx=local_e.clamp(0, epp - 1), within=mine,
                       gate_vals=C.pcopy(r.gate_vals, mp))
    xl = C.pcopy(x, mp).reshape(1, b * s, d)
    w = {k: p[k].to(x.dtype) for k in EXPERT_LEAVES}
    y = combine(experts(w, dispatch(xl, r_loc, epp)), r_loc, torch.float32)
    y = C.psum(y, mp).reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, "swiglu")
    return y, aux
