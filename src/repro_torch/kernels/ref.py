"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held against (on the card
in chip_smoke.py, on the CPU against the JAX package in the tests), and
the path a wrapper takes for tensors that lie on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def lstm_cell_reference(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                        wx: torch.Tensor, wh: torch.Tensor,
                        b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused LSTM cell step (the paper's ICU workload hot-spot).

    x: (B, I); h, c: (B, H); wx: (I, 4H); wh: (H, 4H); b: (4H,).
    Gate order: input, forget, cell(g), output. Returns (h', c') in the
    dtypes of h and c, computed in float32.
    """
    f32 = torch.float32
    gates = (x.to(f32) @ wx.to(f32) + h.to(f32) @ wh.to(f32) + b.to(f32))
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c.to(f32) + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


NEG_INF = -1e30


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        causal: bool, window: Optional[int]) -> torch.Tensor:
    """(Lq, Lk) bool: which keys each query sees (q_pos (Lq, 1) and k_pos
    (1, Lk) absolute positions)."""
    mask = torch.ones(q_pos.shape[0], k_pos.shape[-1], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Full-softmax attention oracle.

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D) with Hq % Hkv == 0 (GQA).
    When Lq != Lk the queries are aligned to the END of the key sequence
    (decode convention: query position i corresponds to absolute position
    Lk - Lq + i). A row with no live key averages over all keys, as the
    reference's softmax over -1e30 logits does. Returns (B, Hq, Lq, D) in
    q.dtype.
    """
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got ({hq}, {hkv})")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    f32 = torch.float32
    qf = q.to(f32)
    kf = torch.repeat_interleave(k.to(f32), group, dim=1)
    vf = torch.repeat_interleave(v.to(f32), group, dim=1)

    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)

    q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = causal_window_mask(q_pos, k_pos, causal, window)
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        block_q: int = 512) -> torch.Tensor:
    """Memory-bounded attention: the same math as attention_reference,
    one q block at a time, so the (Lq, Lk) logits are never whole. For
    windowed attention each q block reads only a (window + block_q) key
    slice, as the reference does."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got ({hq}, {hkv})")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    bq = min(block_q, lq)
    if lq % bq:
        return attention_reference(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    q_off = lk - lq
    kf = torch.repeat_interleave(k, group, dim=1) if group > 1 else k
    vf = torch.repeat_interleave(v, group, dim=1) if group > 1 else v
    use_slice = window is not None and (window + bq) < lk
    kwin = window + bq if use_slice else lk
    f32 = torch.float32

    blocks = []
    for qi in range(lq // bq):
        qb = q[:, :, qi * bq:(qi + 1) * bq]
        q_pos = qi * bq + torch.arange(bq, device=q.device)[:, None] + q_off
        if use_slice:
            start = min(max(qi * bq + q_off - window + 1, 0), lk - kwin)
            kb = kf[:, :, start:start + kwin]
            vb = vf[:, :, start:start + kwin]
        else:
            start = 0
            kb, vb = kf, vf
        k_pos = start + torch.arange(kwin, device=q.device)[None, :]
        logits = torch.einsum("bhqd,bhkd->bhqk", qb.to(f32),
                              kb.to(f32)) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        mask = causal_window_mask(q_pos, k_pos, causal, window)
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1),
                           vb.to(f32))
        blocks.append(out.to(q.dtype))
    return torch.cat(blocks, dim=2)


def ssm_scan_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential Mamba2-style selective-state-space scan oracle.

    x:  (B, L, H, P)   per-head inputs
    dt: (B, L, H)      positive step sizes (already softplus'ed)
    a:  (H,)           negative per-head decay
    b:  (B, L, N)      input projection (single group, shared across heads)
    c:  (B, L, N)      output projection
    d:  (H,)           skip connection
    h0: (B, H, P, N)   optional initial state
    Returns y (B, L, H, P) in x.dtype and the final state (B, H, P, N) in
    float32.
    """
    bs, l, h, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    xf, dtf, bf, cf = x.to(f32), dt.to(f32), b.to(f32), c.to(f32)
    af = a.to(f32)
    if h0 is None:
        state = torch.zeros((bs, h, p, n), dtype=f32, device=x.device)
    else:
        state = h0.to(f32)
    ys = []
    for t in range(l):
        xt, dtt, bt, ct = xf[:, t], dtf[:, t], bf[:, t], cf[:, t]
        decay = torch.exp(dtt * af[None, :])                  # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], bt)
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, ct))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bs, 0, h, p))
    y = y + xf * d.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


def mlstm_chunk_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                      chunk: int = 256
                      ) -> tuple[torch.Tensor,
                                 tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]]:
    """Chunkwise-parallel mLSTM (the reference's `mlstm_chunk_jnp`): the
    re-association of `mlstm_chunk_reference` that the Pallas kernel
    computes, one chunk at a time from a zero state,

        b_t  = cumsum(logsigmoid(f))          per-chunk forget log-decay
        g_u  = i_u - b_u
        cm_t = max(m_in, cummax_{u<=t} g_u)   running stabiliser
        m_t  = b_t + cm_t
        w_tu = exp(g_u - cm_t) [u<=t]         intra-chunk weights
        h_t  = (S_tu v_u + exp(m_in - cm_t) q_t C_in)
               / max(|q_t n_t|, exp(-m_t))

    with S = (q kᵀ / sqrt(D)) ∘ w. A length the chunk does not divide
    takes the sequential oracle, as the reference does.

    Returns (y (B, L, H, D) in q.dtype, (C, n, m) final state, float32).
    """
    bsz, l, h, d = q.shape
    t = min(chunk, l)
    if t == 0 or l % t:
        return mlstm_chunk_reference(q, k, v, i_gate, f_gate)
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))
    c_in = torch.zeros((bsz, h, d, d), dtype=f32, device=q.device)
    n_in = torch.zeros((bsz, h, d), dtype=f32, device=q.device)
    m_in = torch.full((bsz, h), NEG_INF, dtype=f32, device=q.device)
    ys = []
    for c0 in range(0, l, t):
        qc, kc, vc, ic, fc = (x[:, c0:c0 + t].to(f32)
                              for x in (q, k, v, i_gate, f_gate))
        kc = kc * scale
        b = torch.cumsum(torch.nn.functional.logsigmoid(fc), dim=1)
        g = ic - b                                             # (B, T, H)
        cm = torch.maximum(torch.cummax(g, dim=1).values, m_in[:, None])
        m_t = b + cm
        w = torch.exp(g[:, None, :, :] - cm[:, :, None, :])   # (B, T, T, H)
        w = torch.where(causal[None, :, :, None], w, 0.0)
        qk = torch.einsum("bthd,buhd->btuh", qc, kc)
        num = torch.einsum("btuh,buhd->bthd", qk * w, vc)
        inter = torch.exp(m_in[:, None] - cm)                  # (B, T, H)
        num = num + torch.einsum("bthd,bhde->bthe", qc,
                                 c_in) * inter[..., None]
        n_vec = (torch.einsum("btuh,buhd->bthd", w, kc)
                 + n_in[:, None] * inter[..., None])
        den = torch.maximum(
            torch.abs(torch.einsum("bthd,bthd->bth", qc, n_vec)),
            torch.exp(-m_t))
        ys.append(num / den[..., None])

        cm_l, b_l, m_l = cm[:, -1], b[:, -1], m_t[:, -1]       # (B, H)
        w_out = torch.exp(g - cm_l[:, None])                   # (B, T, H)
        carry = torch.exp(b_l + m_in - m_l)                    # (B, H)
        kw = kc * w_out[..., None]
        c_in = (c_in * carry[..., None, None]
                + torch.einsum("bthd,bthe->bhde", kw, vc))
        n_in = n_in * carry[..., None] + kw.sum(dim=1)
        m_in = m_l
    y = torch.cat(ys, dim=1)
    return y.to(q.dtype), (c_in, n_in, m_in)


def mlstm_chunk_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          i_gate: torch.Tensor, f_gate: torch.Tensor,
                          c0: Optional[torch.Tensor] = None,
                          n0: Optional[torch.Tensor] = None,
                          m0: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor,
                                     tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]]:
    """Sequential mLSTM (xLSTM matrix-memory) oracle, stabilised gating
    (arXiv:2405.04517 eq. 19-27).

    q, k, v: (B, L, H, D); i_gate, f_gate: (B, L, H) pre-activation.
    State: C (B, H, D, D) matrix memory, n (B, H, D) normaliser, m (B, H)
    stabiliser; c0/n0/m0 default to 0, 0 and -1e30. Returns (y (B, L, H,
    D) in q.dtype, (C, n, m) final state, float32).
    """
    bs, l, h, d = q.shape
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    ig, fg = i_gate.to(f32), f_gate.to(f32)
    scale = 1.0 / math.sqrt(d)
    c = (torch.zeros((bs, h, d, d), dtype=f32, device=q.device)
         if c0 is None else c0.to(f32))
    n = (torch.zeros((bs, h, d), dtype=f32, device=q.device)
         if n0 is None else n0.to(f32))
    m = (torch.full((bs, h), NEG_INF, dtype=f32, device=q.device)
         if m0 is None else m0.to(f32))
    ys = []
    for t in range(l):
        qt, kt, vt = qf[:, t], kf[:, t], vf[:, t]
        log_f = torch.nn.functional.logsigmoid(fg[:, t])      # (B, H)
        m_new = torch.maximum(log_f + m, ig[:, t])
        fdec = torch.exp(log_f + m - m_new)
        iamp = torch.exp(ig[:, t] - m_new)
        c = c * fdec[..., None, None] + iamp[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", kt * scale, vt)
        n = n * fdec[..., None] + iamp[..., None] * kt * scale
        num = torch.einsum("bhde,bhd->bhe", c, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, qt)),
                            torch.exp(-m_new))
        ys.append(num / den[..., None])
        m = m_new
    y = torch.stack(ys, dim=1) if ys else qf.new_zeros((bs, 0, h, d))
    return y.to(q.dtype), (c, n, m)
