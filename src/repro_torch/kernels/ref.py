"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held against (on the card
in chip_smoke.py, on the CPU against the JAX package in the tests), and
the path a wrapper takes for tensors that lie on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.sharding.policy import DP, constrain


def _recomputed(fn, *args):
    """fn(*args), recomputed in the backward instead of saved when grad
    is enabled (a non-reentrant `torch.utils.checkpoint`, as the reference
    wraps the same loop bodies in `jax.checkpoint`); plain under no_grad."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def walk(step, n: int, carry, inputs: tuple = (), *, dim: int = 1,
         join=torch.stack):
    """The loop of a plain scan: `carry, y = step(t, carry, *inputs)` for
    t = 0 ... n - 1 (n >= 1), the outputs joined along `dim` by `join`
    (`torch.stack`, or `torch.cat` where each output is a block of the
    sequence). Returns (carry, joined). Every per-step or per-block loop
    of the plain versions runs through this function and reads the
    sequence through `inputs`, so that a tracer can stand in for the loop
    (`launch/dryrun.py` traces a few steps of a long scan)."""
    ys = []
    for t in range(n):
        carry, y = step(t, carry, *inputs)
        ys.append(y)
    return carry, join(ys, dim=dim)


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
                        scale: Optional[float] = None,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """Full-softmax attention oracle.

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D) with Hq % Hkv == 0 (GQA).
    When Lq != Lk the queries are aligned to the END of the key sequence
    (decode convention: query position i corresponds to absolute position
    Lk - Lq + i), or start at `q_offset` where it is given (a slice of
    the queries). A row with no live key averages over all keys, as the
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

    q_pos = torch.arange(lq, device=q.device)[:, None] + (
        lk - lq if q_offset is None else q_offset)
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
                        block_q: int = 512,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """Memory-bounded attention: the same math as attention_reference
    (`q_offset` too), one q block at a time, so the (Lq, Lk) logits are
    never whole. For windowed attention each q block reads only a
    (window + block_q) key slice, as the reference does."""
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
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)
    q_off = lk - lq if q_offset is None else q_offset
    kf = torch.repeat_interleave(k, group, dim=1) if group > 1 else k
    vf = torch.repeat_interleave(v, group, dim=1) if group > 1 else v
    use_slice = window is not None and (window + bq) < lk
    kwin = window + bq if use_slice else lk
    f32 = torch.float32

    def block(qb, kb, vb, q_pos, k_pos):
        logits = torch.einsum("bhqd,bhkd->bhqk", qb.to(f32),
                              kb.to(f32)) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        mask = causal_window_mask(q_pos, k_pos, causal, window)
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1),
                           vb.to(f32))
        return out.to(q.dtype)

    # each q block recomputed in the backward: no block's (bq, Lk)
    # probabilities are kept (the reference's jax.checkpoint per block)
    def step(qi, carry, q, kf, vf):
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
        return carry, _recomputed(block, qb, kb, vb, q_pos, k_pos)

    return walk(step, lq // bq, None, (q, kf, vf), dim=2, join=torch.cat)[1]


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

    def step(t, state, xf, dtf, bf, cf):
        xt, dtt, bt, ct = xf[:, t], dtf[:, t], bf[:, t], cf[:, t]
        decay = torch.exp(dtt * af[None, :])                  # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], bt)
        state = state * decay[..., None, None] + upd
        return state, torch.einsum("bhpn,bn->bhp", state, ct)

    if l:
        state, y = walk(step, l, state, (xf, dtf, bf, cf))
    else:
        y = xf.new_zeros((bs, 0, h, p))
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

    def pin(x):
        # batch on dp, replicated elsewhere, as the reference pins the
        # chunked scan's operands (an identity without a policy)
        return constrain(x, (DP,) + (None,) * (x.ndim - 1))

    q, k, v, i_gate, f_gate = (pin(x) for x in (q, k, v, i_gate, f_gate))
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))
    c_in = torch.zeros((bsz, h, d, d), dtype=f32, device=q.device)
    n_in = torch.zeros((bsz, h, d), dtype=f32, device=q.device)
    m_in = torch.full((bsz, h), NEG_INF, dtype=f32, device=q.device)

    def body(qc, kc, vc, ic, fc, c_in, n_in, m_in):
        qc, kc, vc, ic, fc = (x.to(f32) for x in (qc, kc, vc, ic, fc))
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

        cm_l, b_l, m_l = cm[:, -1], b[:, -1], m_t[:, -1]       # (B, H)
        w_out = torch.exp(g - cm_l[:, None])                   # (B, T, H)
        carry = torch.exp(b_l + m_in - m_l)                    # (B, H)
        kw = kc * w_out[..., None]
        c_in = (c_in * carry[..., None, None]
                + torch.einsum("bthd,bthe->bhde", kw, vc))
        n_in = n_in * carry[..., None] + kw.sum(dim=1)
        return num / den[..., None], c_in, n_in, m_l

    # each chunk recomputed in the backward: no chunk's (T, T) weights are
    # kept (the reference scans its chunks under jax.checkpoint)
    def step(i, state, *seq):
        y_c, *state = _recomputed(
            body, *(x[:, i * t:(i + 1) * t] for x in seq), *state)
        return tuple(state), y_c

    (c_in, n_in, m_in), y = walk(step, l // t, (c_in, n_in, m_in),
                                 (q, k, v, i_gate, f_gate), join=torch.cat)
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

    def step(t, state, qf, kf, vf, ig, fg):
        c, n, m = state
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
        return (c, n, m_new), num / den[..., None]

    if l:
        (c, n, m), y = walk(step, l, (c, n, m), (qf, kf, vf, ig, fg))
    else:
        y = qf.new_zeros((bs, 0, h, d))
    return y.to(q.dtype), (c, n, m)
