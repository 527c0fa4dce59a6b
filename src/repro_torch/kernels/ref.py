"""Plain PyTorch versions of the ported kernels (the correctness contract).

Counterpart of ``repro/kernels/ref.py`` for the two kernels of the xLSTM
serving path, plus the chunkwise mLSTM form that the mLSTM kernel computes.
Each is a transparent implementation that the CUDA kernels are held
against on the card and that the CPU path runs.
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
    out = torch.empty_like(z)
    for t in range(s):
        h, c, n, m = slstm_step(h, c, n, m, z[:, :, t], i[:, :, t],
                                f[:, :, t], o[:, :, t], r_all)
        out[:, :, t] = h
    return out
