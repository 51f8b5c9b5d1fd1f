"""Chunkwise mLSTM (xLSTM matrix memory): hand-written CUDA kernels,
forward and backward, and their plain versions.

Port of the Pallas TPU kernel `mlstm_chunk` (src/repro/kernels/
mlstm_chunk.py): q, k, v (B, L, H, D) and the pre-activation gates
(B, L, H) from a zero state; y in q's dtype and the final (C, n, m) in
float32. The CUDA source, `csrc/mlstm_chunk.cu`, says what bounds it on an
H100 and how its design answers that: a block owns 64 value columns of
one head's D×D memory and walks the chunks in order, bf16 inputs run its
products on the tensor cores and float32 inputs on the CUDA cores, and
the last chunk may be ragged, so any L and H work and `block_h` is
accepted for the signature and not used.

Training: on the card, `mlstm_chunk` under autograd is a
`torch.autograd.Function` whose forward launches the serving kernel as it
stands and whose backward is `mlstm_chunk_backward`, the hand-written
`csrc/mlstm_chunk_bwd.cu` (the Pallas kernel has no backward; the
reference differentiates `mlstm_chunk_jnp` by autodiff). It is the exact
gradient of the plain chunkwise function, the stabiliser m included: the
branch of max(|q.n|, exp(-m)) and the cummax's argmax carry gradient too.
The backward recomputes the chunk states rather than have the forward
store them. Its plain version, `mlstm_chunk_backward_plain`, is written
from the formulas; nothing on the card's path runs a plain version.

Each wrapper takes its kernel for CUDA tensors and its plain PyTorch
version for CPU tensors (where autograd differentiates the plain
forward); on the card it launches the kernel or raises. They count their
launches in `mlstm_chunk.launches` and `mlstm_chunk_backward.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
CHUNK = 64          # the kernel's chunk length, the xLSTM call site's


def mlstm_chunk_plain(q, k, v, i_gate, f_gate, *, chunk: int = CHUNK,
                      block_h: int = 4):
    """The kernel's function in plain PyTorch: the chunkwise
    `ref.mlstm_chunk_torch` at the kernel's chunk, which takes the
    sequential oracle where the chunk does not divide L."""
    return ref.mlstm_chunk_torch(q, k, v, i_gate, f_gate, chunk=chunk)


def _check(q, k, v, i_gate, f_gate) -> None:
    for name, t, nd in (("q", q, 4), ("k", k, 4), ("v", v, 4),
                        ("i_gate", i_gate, 3), ("f_gate", f_gate, 3)):
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {t.dim()}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must have one shape")
    bsz, l, h, d = q.shape
    if i_gate.shape != (bsz, l, h) or f_gate.shape != (bsz, l, h):
        raise ValueError(f"gate shapes {tuple(i_gate.shape)} and "
                         f"{tuple(f_gate.shape)} must both be {(bsz, l, h)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("mlstm_chunk takes q, k, v of one dtype, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if i_gate.dtype != torch.float32 or f_gate.dtype != torch.float32:
        raise TypeError("mlstm_chunk takes the gates in float32, got "
                        f"{i_gate.dtype}, {f_gate.dtype}")
    tensors = (q, k, v, i_gate, f_gate)
    if any(t.device != q.device for t in tensors):
        raise ValueError("mlstm_chunk inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim D={d} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlstm_chunk inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("mlstm_chunk").repro_mlstm_chunk
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_entries():
    lib = build.load("mlstm_chunk_bwd")
    size = lib.repro_mlstm_chunk_bwd_workspace
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    fn = lib.repro_mlstm_chunk_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return size, fn



def _forward(q, k, v, i_gate, f_gate):
    """One launch of the forward kernel: (y, (C, n, m))."""
    bsz, l, h, d = q.shape
    f32 = torch.float32
    y = torch.empty_like(q)
    c = torch.empty((bsz, h, d, d), dtype=f32, device=q.device)
    n = torch.empty((bsz, h, d), dtype=f32, device=q.device)
    m = torch.empty((bsz, h), dtype=f32, device=q.device)
    if q.numel() == 0:                # nothing to scan: the zero state
        return y, (c.zero_(), n.zero_(), m.fill_(ref.NEG_INF))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   i_gate.data_ptr(), f_gate.data_ptr(), y.data_ptr(),
                   c.data_ptr(), n.data_ptr(), m.data_ptr(),
                   _DTYPES[q.dtype], bsz, l, h, d, stream)
    if err:
        raise RuntimeError(f"mlstm_chunk kernel launch failed: CUDA error "
                           f"{err}")
    mlstm_chunk.launches += 1
    return y, (c, n, m)


class _MlstmChunk(torch.autograd.Function):
    """The kernel under autograd: the forward launches the forward kernel,
    the backward `mlstm_chunk_backward`'s kernels. Cotangents that
    autograd leaves out (a final state the loss drops) stay None, which
    the backward takes as zero."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i_gate, f_gate)
        y, (c, n, m) = _forward(q, k, v, i_gate, f_gate)
        return y, c, n, m

    @staticmethod
    def backward(ctx, dy, dc, dn, dm):
        q, k, v, i_gate, f_gate = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(q)
        return mlstm_chunk_backward(
            q, k, v, i_gate, f_gate, dy.contiguous(),
            *(None if t is None else t.contiguous() for t in (dc, dn, dm)))


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                chunk: int = CHUNK, block_h: int = 4):
    """q, k, v: (B, L, H, D), float32 or bfloat16; i_gate, f_gate:
    (B, L, H) float32 pre-activation. Returns (y (B, L, H, D) in q's
    dtype, (C (B, H, D, D), n (B, H, D), m (B, H)) float32 final state).
    On the card the kernel's chunk is 64 whatever `chunk` says (the
    chunking changes only the order of float32 sums). Launches on the
    current CUDA stream and does not synchronise. With grad enabled and
    an input that requires it, the backward launches
    `mlstm_chunk_backward`'s kernels; the forward launch is the same
    either way."""
    _check(q, k, v, i_gate, f_gate)
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, i_gate, f_gate, chunk=chunk)
    build.check_card("mlstm_chunk", q)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, i_gate, f_gate)):
        y, c, n, m = _MlstmChunk.apply(q, k, v, i_gate, f_gate)
        return y, (c, n, m)
    return _forward(q, k, v, i_gate, f_gate)


mlstm_chunk.launches = 0


def _chunk_record(qc, kc, vc, ic, fc, c_in, n_in, m_in):
    """The chunkwise forward's record of one chunk (float32, k~ = k /
    sqrt(D) in kc), as `ref.mlstm_chunk_torch` computes it."""
    tn = qc.shape[1]
    b = torch.cumsum(torch.nn.functional.logsigmoid(fc), dim=1)
    g = ic - b                                                 # (B, T, H)
    cmx, idx = torch.cummax(g, dim=1)
    cm = torch.maximum(cmx, m_in[:, None])
    causal = torch.tril(torch.ones((tn, tn), dtype=torch.bool,
                                   device=qc.device))[None, :, :, None]
    w = torch.where(causal, torch.exp(g[:, None] - cm[:, :, None]), 0.0)
    s = torch.einsum("bthd,buhd->btuh", qc, kc) * w            # (B, T, T, H)
    inter = torch.exp(m_in[:, None] - cm)                      # (B, T, H)
    return dict(
        b=b, cmx=cmx, idx=idx, causal=causal, w=w, s=s, inter=inter,
        num=(torch.einsum("btuh,buhd->bthd", s, vc)
             + torch.einsum("bthd,bhde->bthe", qc, c_in) * inter[..., None]),
        qn=s.sum(2) + torch.einsum("bthd,bhd->bth", qc, n_in) * inter,
        em=torch.exp(-(b + cm)), w_out=torch.exp(g - cm[:, -1:]),
        carry=torch.exp(m_in - cm[:, -1]), m_last=b[:, -1] + cm[:, -1])


def _split(q, k, v, i_gate, f_gate):
    f32 = torch.float32
    qf, kf, vf, ig, fg = (t.to(f32) for t in (q, k, v, i_gate, f_gate))
    return qf, kf / math.sqrt(q.shape[-1]), vf, ig, fg


def mlstm_chunk_states_plain(q, k, v, i_gate, f_gate, *,
                             chunk: int = CHUNK, final: bool = False):
    """The states the backward recomputes: (c0, C_in, n_in, m_in) entering
    each chunk of `chunk` steps (the last may be ragged) from the zero
    state, float32; with `final`, also (L, C, n, m) after the last."""
    qf, kf, vf, ig, fg = _split(q, k, v, i_gate, f_gate)
    bsz, l, h, d = q.shape
    c_in = qf.new_zeros((bsz, h, d, d))
    n_in = qf.new_zeros((bsz, h, d))
    m_in = qf.new_full((bsz, h), ref.NEG_INF)
    out = []
    for c0 in range(0, l, chunk):
        out.append((c0, c_in, n_in, m_in))
        sl = slice(c0, min(c0 + chunk, l))
        kc, vc = kf[:, sl], vf[:, sl]
        r = _chunk_record(qf[:, sl], kc, vc, ig[:, sl], fg[:, sl], c_in,
                          n_in, m_in)
        kw = kc * r["w_out"][..., None]
        c_in = (c_in * r["carry"][..., None, None]
                + torch.einsum("bthd,bthe->bhde", kw, vc))
        n_in = n_in * r["carry"][..., None] + kw.sum(1)
        m_in = r["m_last"]
    if final:
        out.append((l, c_in, n_in, m_in))
    return out


def mlstm_chunk_backward_plain(q, k, v, i_gate, f_gate, dy, dc=None,
                               dn=None, dm=None, *, chunk: int = CHUNK):
    """The backward kernel's function in plain PyTorch, written from the
    formulas of `ref.mlstm_chunk_torch`'s chunkwise form (the last chunk
    may be ragged: the same function as the sequential oracle). Per chunk,
    from its recomputed state (`mlstm_chunk_states_plain`), with k~ = k /
    sqrt(D), the record S = (q k~^T) w, inter, w_out, carry of the forward
    and den = max(|qn|, exp(-m)):
        dnum = dy / den;   dden = -(dy . num) / den^2, which goes to qn
        (times sign(qn)) where |qn| wins and to m (times -exp(-m)) where
        exp(-m) wins, half each on a tie (torch.maximum's rule);
        dS = dnum v^T + dqn,   dq = (dS w) k~ + inter (C_in dnum + dqn n_in),
        dk~ = (dS w)^T q + w_out (dC v + dn),
        dv = S^T dnum + w_out dC^T k~,
        dC_in = carry dC + (inter q)^T dnum,  dn_in = carry dn + (inter dqn)^T q;
    then the gates: every weight exp(z - cm) sends its d(weight) weight
    to z and, negated, to cm (or to m_in); m_t = b_t + cm_t; cm = max(m_in,
    cummax g) routes to m_in or to the cummax's argmax (its last index on
    a tie, as torch.cummax); g = i - b; b = cumsum logsigmoid(f); m_in is
    the previous chunk's last m. dc, dn, dm: the final state's cotangents
    (None: zero). float32 math; returns (dq, dk, dv) in q's dtype and
    (di, df) float32."""
    f32 = torch.float32
    qf, kf, vf, ig, fg = _split(q, k, v, i_gate, f_gate)
    dyf = dy.to(f32)
    bsz, l, h, d = q.shape
    d_c = qf.new_zeros((bsz, h, d, d)) if dc is None else dc.to(f32)
    d_n = qf.new_zeros((bsz, h, d)) if dn is None else dn.to(f32)
    d_m = qf.new_zeros((bsz, h)) if dm is None else dm.to(f32)
    dq, dk, dv = (torch.empty_like(qf) for _ in range(3))
    di, df = torch.empty_like(ig), torch.empty_like(fg)
    for c0, c_in, n_in, m_in in reversed(
            mlstm_chunk_states_plain(q, k, v, i_gate, f_gate, chunk=chunk)):
        sl = slice(c0, min(c0 + chunk, l))
        qc, kc, vc, dyc, fc = (t[:, sl] for t in (qf, kf, vf, dyf, fg))
        r = _chunk_record(qc, kc, vc, ig[:, sl], fc, c_in, n_in, m_in)
        qn, em, inter, w_out, carry = (r[x] for x in ("qn", "em", "inter",
                                                      "w_out", "carry"))
        den = torch.maximum(qn.abs(), em)
        dnum = dyc / den[..., None]
        dden = -(dyc * r["num"]).sum(-1) / den ** 2
        qn_wins = (qn.abs() > em).to(f32) + 0.5 * (qn.abs() == em).to(f32)
        dqn = dden * torch.sign(qn) * qn_wins
        dmt = -dden * em * (1.0 - qn_wins)
        dmt[:, -1] += d_m
        ds = torch.where(r["causal"],
                         torch.einsum("bthe,buhe->btuh", dnum, vc)
                         + dqn[:, :, None], 0.0)
        dqk = ds * r["w"]
        c_dnum = (torch.einsum("bhde,bthe->bthd", c_in, dnum)
                  + dqn[..., None] * n_in[:, None])
        dc_v = torch.einsum("bhde,buhe->buhd", d_c, vc) + d_n[:, None]
        dq[:, sl] = (torch.einsum("btuh,buhd->bthd", dqk, kc)
                     + inter[..., None] * c_dnum)
        dk[:, sl] = (torch.einsum("btuh,bthd->buhd", dqk, qc)
                     + w_out[..., None] * dc_v) / math.sqrt(d)
        dv[:, sl] = (torch.einsum("btuh,bthe->buhe", r["s"], dnum)
                     + w_out[..., None]
                     * torch.einsum("bhde,buhd->buhe", d_c, kc))
        # the gates: d(weight) * weight for each exp(.) of the record
        dw = ds * r["s"]                                       # (B, T, T, H)
        d_inter = (qc * c_dnum).sum(-1) * inter
        d_wout = (kc * dc_v).sum(-1) * w_out
        d_carry = ((c_in * d_c).sum((-2, -1)) + (n_in * d_n).sum(-1)) * carry
        dg = dw.sum(1) + d_wout
        dcm = dmt - dw.sum(2) - d_inter
        dcm[:, -1] -= d_wout.sum(1) + d_carry
        cmx = r["cmx"]
        to_g = ((cmx > m_in[:, None]).to(f32)
                + 0.5 * (cmx == m_in[:, None]).to(f32))
        dg = dg.scatter_add(1, r["idx"], dcm * to_g)
        d_m = d_inter.sum(1) + d_carry + (dcm * (1.0 - to_g)).sum(1)
        dlf = torch.flip(torch.cumsum(torch.flip(dmt - dg, (1,)), 1), (1,))
        di[:, sl] = dg
        df[:, sl] = dlf * torch.sigmoid(-fc)
        d_c = (d_c * carry[..., None, None]
               + torch.einsum("bthd,bthe->bhde", qc * inter[..., None], dnum))
        d_n = (d_n * carry[..., None]
               + torch.einsum("bth,bthd->bhd", inter * dqn, qc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), di, df


def mlstm_chunk_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_gate: torch.Tensor, f_gate: torch.Tensor,
                         dy: torch.Tensor, dc: torch.Tensor | None = None,
                         dn: torch.Tensor | None = None,
                         dm: torch.Tensor | None = None):
    """The gradient of `mlstm_chunk` at (q, k, v, i_gate, f_gate): dy the
    gradient of y (q's shape and dtype, contiguous); dc, dn, dm those of
    the final (C, n, m) (float32, contiguous) or None for zero. Returns
    (dq, dk, dv, di, df) as `mlstm_chunk_backward_plain` gives them. On
    the card: one call of `csrc/mlstm_chunk_bwd.cu` (six launches, no
    atomics; the chunk states are recomputed; bf16's products on the
    tensor cores, float32's on the CUDA cores), counted once in
    `mlstm_chunk_backward.launches`; on the CPU,
    `mlstm_chunk_backward_plain`."""
    _check(q, k, v, i_gate, f_gate)
    bsz, l, h, d = q.shape
    if dy.shape != q.shape or dy.dtype != q.dtype or \
            dy.device != q.device or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {q.dtype} tensor of q's "
                         f"shape {tuple(q.shape)} on {q.device}")
    for name, t, shape in (("dc", dc, (bsz, h, d, d)), ("dn", dn, (bsz, h, d)),
                           ("dm", dm, (bsz, h))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{q.device}")
    if q.device.type == "cpu":
        return mlstm_chunk_backward_plain(q, k, v, i_gate, f_gate, dy, dc,
                                          dn, dm)
    build.check_card("mlstm_chunk_backward", q)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    di, df = torch.empty_like(i_gate), torch.empty_like(f_gate)
    if q.numel() == 0:
        return dq, dk, dv, di.zero_(), df.zero_()
    size, fn = _backward_entries()
    work = torch.empty(size(bsz, l, h, d), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*(None if t is None else t.data_ptr()
               for t in (q, k, v, i_gate, f_gate, dy, dc, dn, dm, dq, dk, dv,
                         di, df, work)),
             _DTYPES[q.dtype], bsz, l, h, d, stream)
    if err:
        raise RuntimeError(f"mlstm_chunk_backward kernel launch failed: "
                           f"CUDA error {err}")
    mlstm_chunk_backward.launches += 1
    return dq, dk, dv, di, df


mlstm_chunk_backward.launches = 0
