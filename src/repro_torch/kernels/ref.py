"""Plain PyTorch versions of the ported kernels (the correctness contract).

Counterpart of ``repro/kernels/ref.py`` for every kernel of the port: the
two of the xLSTM serving path (plus the chunkwise mLSTM form that the mLSTM
kernel computes) and the three of the RecurrentGemma path (flash attention,
decode attention, the RG-LRU scan). Each is a transparent implementation
that the CUDA kernels are held against on the card and that the CPU path
runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mlstm_chunkwise(q, k, v, i_raw, f_raw, *, cs: int = 256):
    """Chunkwise-parallel mLSTM from zero state (the math of
    ``kernels/mlstm_scan``). Walks S/cs chunks carrying (C, n, m); within a
    chunk the output is the attention-like parallel form. q,k,v: (B,H,S,D)
    fp32; gates: (B,H,S). Returns (B,H,S,D)."""
    b, h, s, d = q.shape
    cs = min(cs, s)
    if s % cs:
        raise ValueError("pad sequence to the chunk size")
    scale = d ** -0.5
    tri = torch.ones(cs, cs, dtype=torch.bool, device=q.device).tril()
    C = q.new_zeros(b, h, d, d)                    # index [k_dim, v_dim]
    n = q.new_zeros(b, h, d)
    m = q.new_zeros(b, h)
    out = torch.empty_like(q)
    for c0 in range(0, s, cs):
        sl = slice(c0, c0 + cs)
        qc, kc, vc = q[:, :, sl] * scale, k[:, :, sl], v[:, :, sl]
        ic, fc = i_raw[..., sl], f_raw[..., sl]
        bb = torch.cumsum(F.logsigmoid(fc), -1)    # (B,H,cs)
        b_tot = bb[..., -1:]
        dmat = bb[..., :, None] - bb[..., None, :] + ic[..., None, :]
        dmat = dmat.masked_fill(~tri, float("-inf"))
        inter_log = bb + m[..., None]
        m_row = torch.maximum(dmat.amax(-1), inter_log).clamp_min(0.0)
        dexp = torch.exp(dmat - m_row[..., None])
        inter_sc = torch.exp(inter_log - m_row)
        w = (qc @ kc.transpose(-1, -2)) * dexp
        intra = w @ vc
        inter = (qc @ C) * inter_sc[..., None]
        n_t = (qc @ n[..., None])[..., 0] * inter_sc + w.sum(-1)
        denom = torch.maximum(n_t.abs(), torch.exp(-m_row))
        out[:, :, sl] = (intra + inter) / denom[..., None]
        # state update for the next chunk
        m_new = torch.maximum(b_tot[..., 0] + m, (b_tot - bb + ic).amax(-1))
        state_sc = torch.exp(b_tot[..., 0] + m - m_new)
        kw = kc * torch.exp(b_tot - bb + ic - m_new[..., None])[..., None]
        C = state_sc[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = state_sc[..., None] * n + kw.sum(-2)
        m = m_new
    return out


def mlstm_chunk_ref(q, k, v, i_raw, f_raw, state=None):
    """Sequential-oracle mLSTM. q,k,v: (B,H,S,D) fp32; gates: (B,H,S).
    state: optional dict(C,n,m). Returns (h, new_state)."""
    b, h, s, d = q.shape
    if state is None:
        state = {"C": q.new_zeros(b, h, d, d), "n": q.new_zeros(b, h, d),
                 "m": q.new_zeros(b, h)}
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(s):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        log_f = F.logsigmoid(f_raw[..., t])
        m_new = torch.maximum(log_f + m, i_raw[..., t])
        f_sc = torch.exp(log_f + m - m_new)[..., None]
        i_sc = torch.exp(i_raw[..., t] - m_new)[..., None]
        C = f_sc[..., None] * C + i_sc[..., None] * \
            (vt[..., :, None] * kt[..., None, :])   # index [v_dim, k_dim]
        n = f_sc * n + i_sc * kt
        qs = qt * (d ** -0.5)
        num = (C @ qs[..., None])[..., 0]
        den = torch.maximum((n * qs).sum(-1).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, 2), {"C": C, "n": n, "m": m}


def slstm_step(h, c, n, m, zt, it, ft, ot, r_all):
    """One sLSTM step on pre-activations (B,NH,HD) with the four recurrent
    matrices stacked along the output axis, r_all: (NH, HD, 4*HD)."""
    rec = (h[..., None, :] @ r_all)[..., 0, :]     # (B,NH,4*HD)
    hz, hi, hf, ho = rec.chunk(4, -1)
    z = torch.tanh(zt + hz)
    i_log = it + hi
    f_log = F.logsigmoid(ft + hf)
    o = torch.sigmoid(ot + ho)
    m_new = torch.maximum(f_log + m, i_log)
    i_sc = torch.exp(i_log - m_new)
    f_sc = torch.exp(f_log + m - m_new)
    c = f_sc * c + i_sc * z
    n = torch.maximum(f_sc * n + i_sc, torch.exp(-m_new))
    return o * (c / n), c, n, m_new


def slstm_scan_ref(z, i, f, o, rz, ri, rf, ro):
    """Sequential sLSTM oracle on pre-activations from zero state.
    z,i,f,o: (B,NH,S,HD) fp32; r*: (NH,HD,HD) indexed [in, out].
    Returns h (B,NH,S,HD)."""
    b, nh, s, hd = z.shape
    r_all = torch.cat([rz, ri, rf, ro], -1)
    h = c = n = m = z.new_zeros(b, nh, hd)
    hs = []
    for t in range(s):
        h, c, n, m = slstm_step(h, c, n, m, z[:, :, t], i[:, :, t],
                                f[:, :, t], o[:, :, t], r_all)
        hs.append(h)
    return torch.stack(hs, 2)


#: bytes of scores that one block of :func:`flash_attention` may hold, and
#: the multiple of query rows its blocks are cut to
FLASH_SCORE_BYTES = 1 << 30
FLASH_ROW_BLOCK = 512


def flash_row_block(b: int, h: int, sq: int, skv: int, el: int = 4) -> int:
    """Query rows a block of :func:`flash_attention` at these shapes, its
    scores taking ``el`` bytes an element (4: fp32, 8: fp64): every row
    where the (B, H, Sq, Skv) scores fit ``FLASH_SCORE_BYTES``, else the
    largest multiple of ``FLASH_ROW_BLOCK`` rows that fits (at least one
    multiple). In fp32, RecurrentGemma's, Yi-9B's and the MoE models'
    prefills take one block or 2048 rows, Yi-34B's 1024."""
    per_row = el * b * h * skv
    if per_row * sq <= FLASH_SCORE_BYTES:
        return sq
    return max(1, FLASH_SCORE_BYTES // per_row // FLASH_ROW_BLOCK) \
        * FLASH_ROW_BLOCK


def flash_attention(q, k, v, *, causal: bool = True,
                    window: "int | None" = None):
    """Masked softmax attention. q: (B,H,Sq,D); k,v: (B,KV,Skv,D) with
    H = KV*G (query head h reads KV head h // G). Key j is visible to query
    i iff j <= i (causal) and j > i - window. fp32 accumulation (fp64 for
    fp64 inputs); a query with no visible key gives zeros, as the CUDA
    kernel does. The query rows are walked in blocks of
    :func:`flash_row_block` rows: each row's softmax is its own, so the
    blocks bound the peak of the scores without changing the function."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, kv, g, sq, d).to(acc)
    kf, vf = k.to(acc), v.to(acc)
    kpos = torch.arange(skv, device=q.device)[None, :]
    step = flash_row_block(b, h, sq, skv, qg.element_size())
    outs = []
    for q0 in range(0, sq, step):
        rows = slice(q0, min(q0 + step, sq))
        logits = torch.einsum("bkgqd,bksd->bkgqs", qg[:, :, :, rows],
                              kf) * (d ** -0.5)
        qpos = torch.arange(q0, rows.stop, device=q.device)[:, None]
        mask = torch.ones(rows.stop - q0, skv, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        del logits
        probs = probs.masked_fill(~mask.any(-1, keepdim=True), 0.0)
        outs.append(torch.einsum("bkgqs,bksd->bkgqd", probs, vf))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 3)
    return out.reshape(b, h, sq, -1).to(q.dtype)


def decode_attention(q, k, v, lengths):
    """One-token attention against a cache. q: (B,H,D); k,v: (B,S,KV,D)
    in any float type (widened to fp32); lengths: (B,) valid cache length.
    Positions >= lengths[b] are masked; at length 0 the result is zeros,
    as the TPU kernel gives (its jnp oracle gives NaN)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (d ** -0.5)
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None]   # (B,1,1,S)
    probs = torch.softmax(logits.masked_fill(~valid, float("-inf")), -1)
    probs = probs.masked_fill(~valid, 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def rglru_scan(x, a_gate, i_gate, lam, h0=None, c: float = 8.0):
    """RG-LRU over (B,S,W) fp32 inputs: h_t = a_t h_{t-1} + x_hat_t from
    h0 (zeros when None). A log-depth (Hillis-Steele) scan over S, the
    counterpart of ``jax.lax.associative_scan``: ceil(log2 S) rounds of
    whole-tensor work, never a loop over S. The gates first:
    log_a = a_gate * (-c * softplus(-lam)), a = exp(log_a),
    x_hat = sqrt(max(1 - exp(2 log_a), 1e-12)) * i_gate * x.
    Returns (y, h_last)."""
    lam = lam.float()
    log_a = a_gate * (-c * torch.logaddexp(-lam, lam.new_zeros(())))
    a = torch.exp(log_a)
    xs = torch.sqrt(torch.clamp_min(1 - torch.exp(2 * log_a), 1e-12)) \
        * (i_gate * x)
    if h0 is not None:
        xs = torch.cat([xs[:, :1] + a[:, :1] * h0[:, None], xs[:, 1:]], 1)
    s = x.shape[1]
    k = 1
    while k < s:
        # combine((a1, x1), (a2, x2)) = (a1 a2, a2 x1 + x2), offset k
        xs = torch.cat([xs[:, :k], a[:, k:] * xs[:, :-k] + xs[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return xs, xs[:, -1]
