"""xLSTM blocks (Beck et al. 2024) in PyTorch: mLSTM (matrix memory,
parallelizable) and sLSTM (scalar memory, sequential) with exponential
gating. Counterpart of ``repro/models/xlstm.py``.

mLSTM recurrence (per head, d = head_dim):
    C_t = f_t C_{t-1} + i_t v_t k_t^T        (d x d matrix memory)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)
with exponential input gate i = exp(i_raw), sigmoid forget gate in
log-space, stabilized by the running max m_t. A full sequence runs the
quadratic parallel form below 512 tokens and the chunkwise form from 512
tokens on (S % 256 == 0), exactly where the JAX model switches; the
chunkwise form is the ``mlstm_scan`` kernel on a CUDA tensor. The
zero-state sLSTM forward is the ``slstm_scan`` kernel likewise. Decoding
with a cache stays plain PyTorch: the kernels take no initial state.

Weights keep JAX's ``(in, out)`` layout (``x @ w``), not ``nn.Linear``'s.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import mlstm_chunkwise, slstm_step
from .layers import Params, _he, layernorm, layernorm_init, rmsnorm, rmsnorm_init

__all__ = ["XLSTMDims", "mlstm_block_init", "mlstm_parallel_ref",
           "mlstm_chunkwise", "mlstm_decode_step", "mlstm_block_apply",
           "mlstm_cache_init", "slstm_block_init", "slstm_scan",
           "slstm_block_apply", "slstm_cache_init"]


@dataclasses.dataclass(frozen=True)
class XLSTMDims:
    d_model: int
    n_heads: int
    conv_width: int = 4
    proj_factor: float = 2.0       # mLSTM pre-up-projection
    ff_factor: float = 4.0 / 3.0   # sLSTM post-MLP (exact 4/3 -> 1024@768)

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_block_init(gen: torch.Generator, dims: XLSTMDims,
                     dtype=torch.float32, device="cpu") -> Params:
    dev = torch.device(device)
    d, di, nh = dims.d_model, dims.d_inner, dims.n_heads
    s, si = d ** -0.5, di ** -0.5
    f32 = torch.float32
    return {
        "w_up": _he(gen, (d, 2 * di), s, dtype, dev),        # [main, gate]
        "conv_w": _he(gen, (dims.conv_width, di), dims.conv_width ** -0.5,
                      dtype, dev),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "wq": _he(gen, (di, di), si, dtype, dev),
        "wk": _he(gen, (di, di), si, dtype, dev),
        "wv": _he(gen, (di, di), si, dtype, dev),
        "w_i": _he(gen, (di, nh), si, f32, dev),
        "b_i": torch.zeros(nh, dtype=f32, device=dev),
        "w_f": _he(gen, (di, nh), si, f32, dev),
        "b_f": torch.full((nh,), 3.0, dtype=f32, device=dev),  # forget ~ 1
        "out_norm": rmsnorm_init(dims.head_dim, dtype, dev),
        "w_down": _he(gen, (di, d), si, dtype, dev),
    }


def mlstm_parallel_ref(q, k, v, i_raw, f_raw):
    """Parallel (training) form. q,k,v: (B,H,S,D) fp32; i_raw,f_raw: (B,H,S).

    D_ts = exp(cum_f_t - cum_f_s + i_s) for s <= t (stabilized); h = (D*QK^T)V
    normalized by max(|row-sum|, 1) — the mLSTM paper's attention-like form.
    """
    s, d = q.shape[-2:]
    cum_f = torch.cumsum(F.logsigmoid(f_raw), -1)            # (B,H,S)
    dmat = cum_f[..., :, None] - cum_f[..., None, :] + i_raw[..., None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~mask, float("-inf"))
    m = dmat.amax(-1, keepdim=True).clamp_min(0.0)           # (B,H,S,1)
    dexp = torch.exp(dmat - m)
    w = (q @ k.transpose(-1, -2)) * (d ** -0.5) * dexp
    norm = torch.maximum(w.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return (w / norm) @ v


def mlstm_decode_step(state, q, k, v, i_raw, f_raw):
    """One step. state: dict(C:(B,H,D,D), n:(B,H,D), m:(B,H)).
    q,k,v: (B,H,D) fp32; i_raw,f_raw: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    f_sc = torch.exp(log_f + m - m_new)[..., None]
    i_sc = torch.exp(i_raw - m_new)[..., None]
    d = q.shape[-1]
    C = f_sc[..., None] * C + i_sc[..., None] * (v[..., :, None]
                                                 * k[..., None, :])
    n = f_sc * n + i_sc * k
    qs = q * (d ** -0.5)
    num = (C @ qs[..., None])[..., 0]
    den = torch.maximum((n * qs).sum(-1).abs(), torch.exp(-m_new))
    return {"C": C, "n": n, "m": m_new}, num / den[..., None]


def _dw_conv(x, w, b, state=None):
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    return F.silu(out), xp[:, -(k - 1):]


def mlstm_block_apply(p: Params, x: torch.Tensor, dims: XLSTMDims, *,
                      cache: Params | None = None,
                      kernel_impl: str = "hopper",
                      ) -> tuple[torch.Tensor, Params | None]:
    b, s, _ = x.shape
    di, nh, hd = dims.d_inner, dims.n_heads, dims.head_dim
    up = x @ p["w_up"]
    main, gate = up[..., :di], up[..., di:]

    conv_state = cache["conv"] if cache is not None else None
    cmain, new_conv = _dw_conv(main, p["conv_w"], p["conv_b"], conv_state)

    q = (cmain @ p["wq"]).reshape(b, s, nh, hd)
    k = (cmain @ p["wk"]).reshape(b, s, nh, hd)
    v = (main @ p["wv"]).reshape(b, s, nh, hd)
    cf = cmain.float()
    i_raw = cf @ p["w_i"] + p["b_i"]                           # (B,S,H)
    f_raw = cf @ p["w_f"] + p["b_f"]

    qf = q.transpose(1, 2).float()                             # (B,H,S,D)
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2).float()

    if cache is not None:
        state = {"C": cache["C"].float(), "n": cache["n"].float(),
                 "m": cache["m"].float()}
        new_state, h = mlstm_decode_step(
            state, qf[:, :, 0], kf[:, :, 0], vf[:, :, 0],
            i_raw[:, 0], f_raw[:, 0])
        h = h[:, :, None]                                      # (B,H,1,D)
        new_cache = {"C": new_state["C"], "n": new_state["n"],
                     "m": new_state["m"], "conv": new_conv}
    else:
        ir = i_raw.transpose(1, 2).contiguous()
        fr = f_raw.transpose(1, 2).contiguous()
        if s >= 512 and s % 256 == 0:
            # chunkwise form: O(cs^2) not O(S^2) memory
            h = ops.mlstm_scan(qf.contiguous(), kf.contiguous(),
                               vf.contiguous(), ir, fr, cs=256,
                               kernel_impl=kernel_impl)
        else:
            h = mlstm_parallel_ref(qf, kf, vf, ir, fr)         # (B,H,S,D)
        new_cache = None

    h = rmsnorm(p["out_norm"], h.to(x.dtype))
    h = h.transpose(1, 2).reshape(b, s, di)
    y = h * F.silu(gate)
    return y @ p["w_down"], new_cache


def mlstm_cache_init(batch: int, dims: XLSTMDims, dtype=torch.float32,
                     device="cpu") -> Params:
    nh, hd = dims.n_heads, dims.head_dim
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    return {"C": z(batch, nh, hd, hd), "n": z(batch, nh, hd),
            "m": z(batch, nh), "conv": z(batch, dims.conv_width - 1,
                                         dims.d_inner)}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_block_init(gen: torch.Generator, dims: XLSTMDims,
                     dtype=torch.float32, device="cpu") -> Params:
    dev = torch.device(device)
    d, nh = dims.d_model, dims.n_heads
    hd = d // nh
    s = d ** -0.5
    dff = int(d * dims.ff_factor)
    p = {"norm": layernorm_init(d, dtype, dev),
         "out_norm": rmsnorm_init(hd, dtype, dev),
         "w_ff_up": _he(gen, (d, 2 * dff), s, dtype, dev),
         "w_ff_down": _he(gen, (dff, d), dff ** -0.5, dtype, dev)}
    for g in ("z", "i", "f", "o"):
        p[f"w_{g}"] = _he(gen, (d, d), s, dtype, dev)
        p[f"r_{g}"] = _he(gen, (nh, hd, hd), hd ** -0.5, dtype, dev)
        p[f"b_{g}"] = torch.full((d,), 3.0 if g == "f" else 0.0,
                                 dtype=torch.float32, device=dev)
    return p


def slstm_scan(p: Params, x: torch.Tensor, nh: int,
               state: Params | None = None, *, kernel_impl: str = "hopper",
               ) -> tuple[torch.Tensor, Params | None]:
    """Sequential sLSTM over time (the recurrent weight R makes it
    non-parallelizable — the paper's point). x: (B,S,d) -> (B,S,d).

    From zero state (``state=None``) the whole sequence is one
    ``slstm_scan`` kernel call, which returns no final state, so the
    second result is None; with a state the steps run in plain PyTorch and
    the final state is returned."""
    b, s, d = x.shape
    hd = d // nh
    pre = [(x @ p[f"w_{g}"]).float() + p[f"b_{g}"] for g in "zifo"]
    pre = [t.reshape(b, s, nh, hd) for t in pre]
    rs = [p[f"r_{g}"].float() for g in "zifo"]

    if state is None:
        seq = [t.transpose(1, 2).contiguous() for t in pre]   # (B,NH,S,HD)
        hs = ops.slstm_scan(*seq, *(r.contiguous() for r in rs),
                            kernel_impl=kernel_impl)
        return hs.transpose(1, 2).reshape(b, s, d), None

    r_all = torch.cat(rs, -1)
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(s):
        h, c, n, m = slstm_step(h, c, n, m, pre[0][:, t], pre[1][:, t],
                                pre[2][:, t], pre[3][:, t], r_all)
        hs.append(h)
    return (torch.stack(hs, 1).reshape(b, s, d),
            {"c": c, "n": n, "h": h, "m": m})


def slstm_block_apply(p: Params, x: torch.Tensor, dims: XLSTMDims, *,
                      cache: Params | None = None,
                      kernel_impl: str = "hopper",
                      ) -> tuple[torch.Tensor, Params | None]:
    b, s, d = x.shape
    nh = dims.n_heads
    hd = d // nh
    xin = layernorm(p["norm"], x)
    state = None
    if cache is not None:
        state = {"c": cache["c"].float(), "n": cache["n"].float(),
                 "h": cache["hs"].float(), "m": cache["m"].float()}
    h, final = slstm_scan(p, xin, nh, state, kernel_impl=kernel_impl)
    h = rmsnorm(p["out_norm"], h.reshape(b, s, nh, hd).to(x.dtype)) \
        .reshape(b, s, d)
    # gated feed-forward (post-up-projection, factor 4/3, GeGLU with JAX's
    # default tanh-approximate gelu)
    up = h @ p["w_ff_up"]
    dff = up.shape[-1] // 2
    y = F.gelu(up[..., :dff], approximate="tanh") * up[..., dff:]
    out = y @ p["w_ff_down"]
    new_cache = None
    if cache is not None:
        new_cache = {"c": final["c"], "n": final["n"],
                     "hs": final["h"], "m": final["m"]}
    return out, new_cache


def slstm_cache_init(batch: int, dims: XLSTMDims, dtype=torch.float32,
                     device="cpu") -> Params:
    nh = dims.n_heads
    hd = dims.d_model // nh
    return {name: torch.zeros(batch, nh, hd, dtype=dtype, device=device)
            for name in ("c", "n", "hs", "m")}
