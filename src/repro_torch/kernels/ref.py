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
