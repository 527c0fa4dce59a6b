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
    return _mlstm_chunks(q, k, v, i_raw, f_raw, cs, save=False)[0]


def mlstm_chunkwise_fwd_states_ref(q, k, v, i_raw, f_raw, *, cs: int = 256):
    """:func:`mlstm_chunkwise` (its h bit for bit at the same ``cs``) that
    also returns what :func:`mlstm_chunkwise_bwd_ref` reads, in the
    training forward kernel's layout (the kernel's at ``cs=16``):
    ``(h, (C, n, m, m_row, n_row))``, each chunk's starting state C
    (B,H,S/cs,D,D) indexed [k_dim, v_dim], n (B,H,S/cs,D) and stabiliser
    m (B,H,S/cs), then each row's stabiliser m_row and signed normaliser
    n_t (B,H,S), whose magnitude the denominator max(|n_t|, exp(-m_row))
    takes."""
    return _mlstm_chunks(q, k, v, i_raw, f_raw, cs, save=True)


def _mlstm_chunks(q, k, v, i_raw, f_raw, cs: int, save: bool):
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
    saved = ([], [], [], [], []) if save else None
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
        if save:
            for keep, x in zip(saved, (C, n, m, m_row, n_t)):
                keep.append(x)
        # state update for the next chunk
        m_new = torch.maximum(b_tot[..., 0] + m, (b_tot - bb + ic).amax(-1))
        state_sc = torch.exp(b_tot[..., 0] + m - m_new)
        kw = kc * torch.exp(b_tot - bb + ic - m_new[..., None])[..., None]
        C = state_sc[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = state_sc[..., None] * n + kw.sum(-2)
        m = m_new
    if not save:
        return out, None
    starts = tuple(torch.stack(x, 2) for x in saved[:3])
    return out, (*starts, torch.cat(saved[3], -1), torch.cat(saved[4], -1))


def mlstm_gate_grads(q, k, f_raw, dq, dk):
    """The mLSTM's gate gradients from dq and dk. The function reads k_s
    only as exp(i_s) k_s, and q_t and k_s only as exp(B_t) q_t and
    exp(-B_s) k_s, B the cumulative log f over the sequence; so
    di_s = k_s . dk_s and d(log f)_u = sum over t >= u of
    (q_t . dq_t - k_t . dk_t), and df = d(log f) sigmoid(-f). Returns
    (di, df), (B,H,S) each. The kernel's backward calls it too."""
    di = (k * dk).sum(-1)
    db = (q * dq).sum(-1) - di
    return di, db.flip(-1).cumsum(-1).flip(-1) * torch.sigmoid(-f_raw)


def mlstm_chunkwise_bwd_ref(q, k, v, i_raw, f_raw, h, states, grad_h, *,
                            cs: int = 256):
    """The chunkwise mLSTM's backward in explicit formulas, walking the
    chunks from last to first: the plain version of the backward kernel.
    ``h`` and ``states`` are :func:`mlstm_chunkwise_fwd_states_ref`'s at
    the same ``cs`` (or the training forward kernel's, at ``cs=16``);
    ``grad_h`` (B,H,S,D). Returns the gradients of q, k, v, i_raw, f_raw.

    h does not depend on the stabilisers: h_t = H_t / max(|N_t|, 1) in
    the unstabilised sums, so no m has an adjoint. The adjoints dC (D x D)
    and dn (D) of a chunk's starting state are carried at that chunk's
    stabiliser m_c, so every factor is one the forward computed and none
    exceeds 1: the state's decay exp(b_tot + m_c - m_{c+1}) carries them to
    the chunk before, the inter-chunk scale exp(b_t + m_c - m_row_t) takes
    row t's part, and k_s's contribution exp(b_tot - b_s + i_s - m_{c+1})
    gives dk and dv theirs. Row t's output grad enters as
    G_t = grad_h_t / denom_t and its normaliser grad as
    g_t = -(G_t . h_t) d|n_t|, where d|n_t| splits a tie of |n_t| with
    exp(-m_row) in half (as ``torch.maximum``'s gradient) and sign(0) = 0.
    The gate grads follow from dq and dk (:func:`mlstm_gate_grads`)."""
    b, nh, s, d = q.shape
    cs = min(cs, s)
    if s % cs:
        raise ValueError("pad sequence to the chunk size")
    C0, n0, m0, m_rows, n_rows = states
    if C0.shape[2] != s // cs:
        raise ValueError(f"states hold {C0.shape[2]} chunks, expected "
                         f"{s // cs} of {cs} rows")
    scale = d ** -0.5
    tri = torch.ones(cs, cs, dtype=torch.bool, device=q.device).tril()
    dC = q.new_zeros(b, nh, d, d)
    dn = q.new_zeros(b, nh, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for c in reversed(range(s // cs)):
        sl = slice(c * cs, (c + 1) * cs)
        qc, kc, vc = q[:, :, sl] * scale, k[:, :, sl], v[:, :, sl]
        ic, fc = i_raw[..., sl], f_raw[..., sl]
        m_prev, m_row, n_t = m0[..., c], m_rows[..., sl], n_rows[..., sl]
        # the forward's factors of chunk c
        bb = torch.cumsum(F.logsigmoid(fc), -1)
        b_tot = bb[..., -1:]
        dmat = bb[..., :, None] - bb[..., None, :] + ic[..., None, :]
        dexp = torch.exp(dmat.masked_fill(~tri, float("-inf"))
                         - m_row[..., None])
        inter_sc = torch.exp(bb + m_prev[..., None] - m_row)
        m_new = torch.maximum(b_tot[..., 0] + m_prev,
                              (b_tot - bb + ic).amax(-1))
        contrib = torch.exp(b_tot - bb + ic - m_new[..., None])
        state_sc = torch.exp(b_tot[..., 0] + m_prev - m_new)
        em, an = torch.exp(-m_row), n_t.abs()
        dabs = _tie_weight(an, em) * torch.sign(n_t)
        # row t's grads of the numerator (G) and the normaliser (g)
        G = grad_h[:, :, sl] / torch.maximum(an, em)[..., None]
        g = -(G * h[:, :, sl]).sum(-1) * dabs
        w = (qc @ kc.transpose(-1, -2)) * dexp
        p = dexp * (G @ vc.transpose(-1, -2) + g[..., None])   # [t, s]
        dqc = (inter_sc[..., None] * (G @ C0[:, :, c].transpose(-1, -2)
                                      + g[..., None] * n0[:, :, c, None, :])
               + p @ kc)
        dk[:, :, sl] = p.transpose(-1, -2) @ qc + contrib[..., None] * (
            vc @ dC.transpose(-1, -2) + dn[..., None, :])
        dv[:, :, sl] = w.transpose(-1, -2) @ G + contrib[..., None] * (
            kc @ dC)
        dq[:, :, sl] = dqc * scale
        qx = qc * inter_sc[..., None]
        dC = state_sc[..., None, None] * dC + qx.transpose(-1, -2) @ G
        dn = state_sc[..., None] * dn + (qx * g[..., None]).sum(-2)
    return (dq, dk, dv, *mlstm_gate_grads(q, k, f_raw, dq, dk))


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


def _slstm_cell(c, n, m, pz, pi, pf, po):
    """The sLSTM cell on the four pre-activations (recurrent part in):
    returns h, c, n, m of the step."""
    z = torch.tanh(pz)
    f_log = F.logsigmoid(pf)
    o = torch.sigmoid(po)
    m_new = torch.maximum(f_log + m, pi)
    i_sc = torch.exp(pi - m_new)
    f_sc = torch.exp(f_log + m - m_new)
    c = f_sc * c + i_sc * z
    n = torch.maximum(f_sc * n + i_sc, torch.exp(-m_new))
    return o * (c / n), c, n, m_new


def slstm_step(h, c, n, m, zt, it, ft, ot, r_all):
    """One sLSTM step on pre-activations (B,NH,HD) with the four recurrent
    matrices stacked along the output axis, r_all: (NH, HD, 4*HD)."""
    rec = (h[..., None, :] @ r_all)[..., 0, :]     # (B,NH,4*HD)
    hz, hi, hf, ho = rec.chunk(4, -1)
    return _slstm_cell(c, n, m, zt + hz, it + hi, ft + hf, ot + ho)


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


def slstm_scan_fwd_states_ref(z, i, f, o, rz, ri, rf, ro):
    """:func:`slstm_scan_ref` (its h bit for bit) that also returns what
    :func:`slstm_scan_bwd_ref` reads, in the training forward kernel's
    layout: ``(h, states)``, states (7,B,NH,S,HD) holding the
    pre-activations of z, i, f, o with their recurrent part, then c, n and
    m of every step."""
    b, nh, s, hd = z.shape
    r_all = torch.cat([rz, ri, rf, ro], -1)
    h = c = n = m = z.new_zeros(b, nh, hd)
    hs, saved = [], []
    for t in range(s):
        rec = (h[..., None, :] @ r_all)[..., 0, :]
        hz, hi, hf, ho = rec.chunk(4, -1)
        pre = (z[:, :, t] + hz, i[:, :, t] + hi, f[:, :, t] + hf,
               o[:, :, t] + ho)
        h, c, n, m = _slstm_cell(c, n, m, *pre)
        hs.append(h)
        saved.append(torch.stack([*pre, c, n, m]))
    return torch.stack(hs, 2), torch.stack(saved, 3)


def _tie_weight(a, b):
    """d max(a, b) / d a: 1 where a > b, 0 where a < b, a half at a tie (as
    ``torch.maximum``'s and ``jnp.maximum``'s gradients split it)."""
    return torch.where(a > b, 1.0, torch.where(a < b, 0.0, 0.5)).to(a.dtype)


def slstm_recurrent_grads(h, dpre):
    """dR_g = sum over b, t of h_{t-1}^T dpre_g[t] (h_{-1} = 0) for the four
    gates at once, as one batched product: h (B,NH,S,HD), dpre
    (4,B,NH,S,HD). Returns dr_z, dr_i, dr_f, dr_o (NH,HD,HD). The kernel's
    backward calls it too: the JAX package leaves this product to XLA."""
    b, nh, s, hd = h.shape
    hp = F.pad(h, (0, 0, 1, 0))[:, :, :s]
    a = hp.permute(1, 3, 0, 2).reshape(nh, hd, b * s)
    d = dpre.permute(2, 1, 3, 0, 4).reshape(nh, b * s, 4 * hd)
    return tuple(r.contiguous() for r in torch.bmm(a, d).split(hd, -1))


def slstm_scan_bwd_ref(h, states, rz, ri, rf, ro, grad_h):
    """The sLSTM's backward in explicit formulas, walking t from S-1 down
    to 0: the plain version of the backward kernel. ``h`` and ``states``
    are :func:`slstm_scan_fwd_states_ref`'s (or the training forward
    kernel's); ``grad_h`` (B,NH,S,HD). Carries the adjoints of h's
    recurrent part, c, n and m; per step the cell runs backward through
    h = o c / n, n = max(f' n + i', exp(-m)), c = f' c + i' z,
    i' = exp(i - m), f' = exp(log f + m_prev - m), m = max(log f + m_prev,
    i), each maximum splitting a tie in half. Returns the gradients of z,
    i, f, o (each gate's dpre) and of r_z, r_i, r_f, r_o."""
    pz, pi, pf, po, cs, ns, ms = states
    b, nh, s, hd = h.shape
    r_t = torch.cat([rz, ri, rf, ro], -1).transpose(-1, -2)  # (NH,4HD,HD)
    zero = h.new_zeros(b, nh, hd)
    dh_rec = dc = dn = dm = zero
    dpre = h.new_empty(4, b, nh, s, hd)
    for t in reversed(range(s)):
        c_p, n_p, m_p = ((cs[:, :, t - 1], ns[:, :, t - 1], ms[:, :, t - 1])
                         if t else (zero, zero, zero))
        p_z, p_i, p_f, p_o = (p[:, :, t] for p in (pz, pi, pf, po))
        c, n = cs[:, :, t], ns[:, :, t]
        # the forward's cell of step t
        zz, oo = torch.tanh(p_z), torch.sigmoid(p_o)
        mf = F.logsigmoid(p_f) + m_p
        m = torch.maximum(mf, p_i)
        i_sc, f_sc = torch.exp(p_i - m), torch.exp(mf - m)
        nv, em = f_sc * n_p + i_sc, torch.exp(-m)
        # h = o (c / n)
        dh = grad_h[:, :, t] + dh_rec
        cn = c / n
        dcn = dh * oo
        dcc = dc + dcn / n
        dnn = dn - dcn * cn / n
        # n = max(nv, exp(-m))
        wn = _tie_weight(nv, em)
        dnv = dnn * wn
        dmm = dm - dnn * (1 - wn) * em
        # c = f' c_p + i' z, nv = f' n_p + i'
        gi = (dcc * zz + dnv) * i_sc
        gf = (dcc * c_p + dnv * n_p) * f_sc
        dmm = dmm - (gi + gf)
        # m = max(mf, i), mf = log f + m_p
        wm = _tie_weight(mf, p_i)
        dmf = gf + dmm * wm
        d = torch.stack([dcc * i_sc * (1 - zz * zz), gi + dmm * (1 - wm),
                         dmf * torch.sigmoid(-p_f),
                         dh * cn * oo * (1 - oo)])
        dpre[:, :, :, t] = d
        dh_rec = (torch.cat(tuple(d), -1)[..., None, :] @ r_t)[..., 0, :]
        dc, dn, dm = dcc * f_sc, dnv * f_sc, dmf
    return (*dpre.unbind(0), *slstm_recurrent_grads(h, dpre))


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
