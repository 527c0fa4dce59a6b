"""Multi-head Latent Attention (DeepSeek-V2 style, used by MiniCPM3) in
PyTorch. Counterpart of ``repro/models/mla.py``.

KV is compressed into a low-rank latent c_kv (r_kv) plus one rotary key
k_rope shared by every head; the decode cache stores only (c_kv, k_rope),
r_kv + dr values a token. Queries come from their own low-rank latent.
The prefill expands the latent into per-head keys and values and runs the
plain masked attention (``layers.sdpa``: q and k at dn + dr dims, v at dv);
a decode step attends in the latent space with ``wkv_b`` absorbed into the
query and output sides. Neither has a kernel in the reference, so both stay
plain PyTorch here.
"""

from __future__ import annotations

import dataclasses

import torch

from .layers import Params, _he, apply_rope, rmsnorm, rmsnorm_init, sdpa


@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    n_heads: int
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


def mla_init(gen: torch.Generator, dims: MLADims, dtype=torch.float32,
             device="cpu") -> Params:
    """The reference's leaves, (in, out) each, drawn one at a time from
    ``gen``."""
    dev = torch.device(device)
    d, h = dims.d_model, dims.n_heads
    r_q, r_kv = dims.q_lora_rank, dims.kv_lora_rank
    dn, dr, dv = dims.qk_nope_dim, dims.qk_rope_dim, dims.v_head_dim
    s = d ** -0.5
    return {
        "wq_a": _he(gen, (d, r_q), s, dtype, dev),
        "q_a_norm": rmsnorm_init(r_q, dtype, dev),
        "wq_b": _he(gen, (r_q, h * (dn + dr)), r_q ** -0.5, dtype, dev),
        "wkv_a": _he(gen, (d, r_kv + dr), s, dtype, dev),
        "kv_a_norm": rmsnorm_init(r_kv, dtype, dev),
        "wkv_b": _he(gen, (r_kv, h * (dn + dv)), r_kv ** -0.5, dtype, dev),
        "wo": _he(gen, (h * dv, d), (h * dv) ** -0.5, dtype, dev),
    }


def mla_apply(p: Params, x: torch.Tensor, dims: MLADims, *,
              positions: "torch.Tensor | None" = None,
              cache: "Params | None" = None,
              rope_theta: float = 1e6,
              norm_eps: float = 1e-6) -> tuple[torch.Tensor, "Params | None"]:
    """Without a cache, the whole sequence rotated at ``positions`` ((B,S),
    0..S-1 by default) through causal ``sdpa`` with k_rope broadcast over
    the heads. With one, x is (B, 1, d) and the cache is {"c_kv": (B,Smax,
    r_kv), "k_rope": (B,Smax,1,dr), "pos": (B,) int32}: the token's latents
    are written in place at slot ``pos``, where a write at ``pos >= Smax``
    is dropped, as JAX's scatter drops it (the valid slots are then all
    Smax); its scores are summed in x's type, then softmaxed in fp32.
    Returns (out, new_cache)."""
    b, s, _ = x.shape
    h = dims.n_heads
    dn, dr, dv = dims.qk_nope_dim, dims.qk_rope_dim, dims.v_head_dim
    r_kv = dims.kv_lora_rank

    q_lat = rmsnorm(p["q_a_norm"], x @ p["wq_a"], norm_eps)
    q = (q_lat @ p["wq_b"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    kv_a = x @ p["wkv_a"]                                       # (B,S,r+dr)
    c_kv = rmsnorm(p["kv_a_norm"], kv_a[..., :r_kv], norm_eps)
    k_rope = kv_a[..., r_kv:][:, :, None, :]                    # (B,S,1,dr)

    if cache is not None:
        # absorbed decode: wkv_b folded into the query and output sides,
        # so the step attends to the r_kv-dim latents without expanding
        # them to per-head keys and values
        pos = cache["pos"]                                      # (B,)
        q_rope = apply_rope(q_rope, pos[:, None], rope_theta)
        k_rope = apply_rope(k_rope, pos[:, None], rope_theta)
        ckv, ckr = cache["c_kv"], cache["k_rope"]
        smax = ckv.shape[1]
        rows = torch.arange(b, device=x.device)
        # past the end the slot's old contents are written back, so
        # nothing changes and pos never leaves the device
        slot = pos.clamp(max=smax - 1).long()
        keep = (pos >= smax)[:, None]
        ckv_new = torch.where(keep, ckv[rows, slot],
                              c_kv[:, 0].to(ckv.dtype))
        ckr_new = torch.where(keep[:, :, None], ckr[rows, slot],
                              k_rope[:, 0].to(ckr.dtype))
        ckv[rows, slot] = ckv_new                               # in place
        ckr[rows, slot] = ckr_new
        wkv = p["wkv_b"].reshape(r_kv, h, dn + dv)
        w_k, w_v = wkv[..., :dn], wkv[..., dn:]                 # (r,H,*)
        q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_k)     # (B,1,H,r)
        ckv_x = ckv.to(x.dtype)
        scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, ckv_x)
                  + torch.einsum("bqhd,bsd->bhqs", q_rope,
                                 ckr[:, :, 0].to(x.dtype))) \
            * ((dn + dr) ** -0.5)
        valid = (torch.arange(smax, device=x.device)[None, :]
                 < (pos + 1)[:, None])                          # (B,Smax)
        scores = scores.float().masked_fill(~valid[:, None, None], -1e30)
        probs = torch.softmax(scores, -1).to(x.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", probs, ckv_x)      # latent ctx
        out = torch.einsum("bqhr,rhd->bqhd", ctx, w_v)          # (B,1,H,dv)
        new_cache = {"c_kv": ckv, "k_rope": ckr, "pos": pos + 1}
    else:
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q_rope = apply_rope(q_rope, positions, rope_theta)
        k_rope = apply_rope(k_rope, positions, rope_theta)
        kv = (c_kv @ p["wkv_b"]).reshape(b, s, h, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        out = sdpa(qq, k, v, causal=True)
        new_cache = None

    out = out.reshape(b, s, h * dv)
    return out @ p["wo"], new_cache


def mla_cache_init(batch: int, max_seq: int, dims: MLADims,
                   dtype=torch.bfloat16, device="cpu") -> Params:
    return {
        "c_kv": torch.zeros((batch, max_seq, dims.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_seq, 1, dims.qk_rope_dim),
                              dtype=dtype, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }
