"""Fused LSTM cell: hand-written CUDA kernels and their plain versions.

Port of the Pallas TPU kernel `lstm_cell` (src/repro/kernels/lstm_cell.py)
and of its scan over time in the reference's `ICULSTM.forward`. Two entry
points: `lstm_cell`, one step, and `lstm_sequence`, a whole layer over T
steps from a zero state in one launch. The CUDA source,
`csrc/lstm_cell.cu`, says what bounds them on an H100 and how their
designs answer that. Weights keep the reference's (I, 4, H) / (H, 4, H) /
(4, H) layout, so a hidden unit's four gates sit H apart.

Inputs are float32 or bfloat16 and the math is float32, as the Pallas
cell casts them: `lstm_cell` reads each input in its own dtype and writes
h' and c' in h's and c's; `lstm_sequence` takes one dtype for all its
inputs and returns h and c in it (rounded to it after every step, as a
scan of the cell carries them).

Training: on the card, `lstm_sequence` under autograd is a
`torch.autograd.Function`. Its forward launches the training instance of
the sequence kernel, which also records every step's activated gates and
cell state (float32); its backward is `lstm_sequence_backward`, the
whole layer's gradient in two hand-written launches: the serial chain back
through time with the products off it (dxs and each batch row's partial
weight gradients) in one, the rows' partials summed in a fixed order in
the other. Its plain version, `lstm_sequence_backward_plain`, is written
from the formulas.
The one-step `lstm_cell` is on no training path and raises under grad on
the card rather than return a tensor autograd cannot see.

Each wrapper takes its kernel for CUDA tensors and its plain PyTorch
version for CPU tensors (where autograd differentiates the plain scan);
on the card it launches the kernel or raises. They count their launches
in `lstm_cell.launches`, `lstm_sequence.launches` (forward, serving and
training) and `lstm_sequence_backward.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

# the largest x-row + h-row a block can stage in shared memory on Hopper
_MAX_SMEM_BYTES = 232_448
# lstm_sequence: one thread per gate column, at most 1024 a block; a
# segment of at least _SEQ_TC steps in csrc/lstm_cell.cu's SEQ_SMEM_CAP
MAX_SEQUENCE_HIDDEN = 256
_SEQ_TC = 16
_SEQ_SMEM_CAP = 200 * 1024


def lstm_cell_plain(x, h, c, wx, wh, b):
    """The plain PyTorch version of the kernel, on the (I, 4, H) layout."""
    i_dim, _, h_dim = wx.shape
    return ref.lstm_cell_reference(x, h, c, wx.reshape(i_dim, 4 * h_dim),
                                   wh.reshape(h_dim, 4 * h_dim),
                                   b.reshape(4 * h_dim))


def lstm_sequence_plain(xs, wx, wh, b, *, return_sequence: bool = False):
    """The plain version of the sequence kernel: a Python scan of
    `lstm_cell_plain` from h = c = 0, as the reference's `ICULSTM.forward`
    scans its cell. Returns (h_T, c_T, hs (T, B, H) or None)."""
    h = c = xs.new_zeros((xs.shape[1], wh.shape[0]))
    hs = []
    for xt in xs:
        h, c = lstm_cell_plain(xt, h, c, wx, wh, b)
        hs.append(h)
    if not return_sequence:
        return h, c, None
    return h, c, torch.stack(hs) if hs else xs.new_zeros((0,) + h.shape)


def _check_weights(i_dim, h_dim, wx, wh, b) -> None:
    if wx.shape != (i_dim, 4, h_dim):
        raise ValueError(f"wx shape {tuple(wx.shape)} != {(i_dim, 4, h_dim)}")
    if wh.shape != (h_dim, 4, h_dim):
        raise ValueError(f"wh shape {tuple(wh.shape)} != {(h_dim, 4, h_dim)}")
    if b is not None and b.shape != (4, h_dim):
        raise ValueError(f"b shape {tuple(b.shape)} != {(4, h_dim)}")


_DTYPES = (torch.float32, torch.bfloat16)


def _check_tensors(op, tensors, *, one_dtype: bool) -> None:
    dtypes = {t.dtype for t in tensors}
    if not dtypes <= set(_DTYPES) or (one_dtype and len(dtypes) > 1):
        kind = "one dtype, float32 or bfloat16" if one_dtype \
            else "float32 or bfloat16 inputs"
        raise TypeError(f"{op} takes {kind}, got "
                        f"{sorted(str(d) for d in dtypes)}")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{op} inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{op} inputs must be contiguous")


def _check(x, h, c, wx, wh, b) -> None:
    for name, t, nd in (("x", x, 2), ("h", h, 2), ("c", c, 2),
                        ("wx", wx, 3), ("wh", wh, 3), ("b", b, 2)):
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {t.dim()}")
    bsz, i_dim = x.shape
    h_dim = h.shape[1]
    if h.shape != (bsz, h_dim) or c.shape != (bsz, h_dim):
        raise ValueError(f"h {tuple(h.shape)} and c {tuple(c.shape)} must "
                         f"both be {(bsz, h_dim)}")
    _check_weights(i_dim, h_dim, wx, wh, b)
    _check_tensors("lstm_cell", (x, h, c, wx, wh, b), one_dtype=False)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("lstm_cell").repro_lstm_cell
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_sequence(xs, wx, wh, b) -> None:
    """b None: the backward, which takes no bias."""
    named = [("xs", xs, 3), ("wx", wx, 3), ("wh", wh, 3)]
    if b is not None:
        named.append(("b", b, 2))
    for name, t, nd in named:
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {t.dim()}")
    _check_weights(xs.shape[2], wh.shape[0], wx, wh, b)
    _check_tensors("lstm_sequence", [t for _, t, _ in named], one_dtype=True)


@functools.lru_cache(maxsize=None)
def _sequence_entry():
    fn = build.load("lstm_cell").repro_lstm_sequence
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_entry():
    lib = build.load("lstm_cell")
    fn = lib.repro_lstm_sequence_backward
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.repro_lstm_sequence_backward_workspace
    ws.argtypes = [ctypes.c_int] * 3
    ws.restype = ctypes.c_longlong
    return fn, ws


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              wx: torch.Tensor, wh: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, I); h, c: (B, H); wx: (I, 4, H); wh: (H, 4, H); b: (4, H).

    Gate order i, f, g, o; each input float32 or bfloat16, float32 math.
    Returns (h', c') in h's and c's dtypes. Launches on the current CUDA
    stream and does not synchronise."""
    _check(x, h, c, wx, wh, b)
    if x.device.type == "cpu":
        return lstm_cell_plain(x, h, c, wx, wh, b)
    build.check_card("lstm_cell", x)
    if _wants_grad(x, h, c, wx, wh, b):
        raise NotImplementedError(
            "lstm_cell has no gradient, as the reference's Pallas cell has "
            "none (jax.grad through it raises): ICULSTM trains through "
            "lstm_sequence, whose backward is lstm_sequence_backward")
    bsz, i_dim = x.shape
    h_dim = h.shape[1]
    if (i_dim + h_dim) * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"I + H = {i_dim + h_dim} floats exceed a block's "
                         f"shared memory")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    if bsz == 0 or h_dim == 0:
        return h_out, c_out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # bit k: input k of (x, h, c, wx, wh, b) is bfloat16
    dtypes = sum(1 << k for k, t in enumerate((x, h, c, wx, wh, b))
                 if t.dtype == torch.bfloat16)
    err = _entry()(x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
                   wh.data_ptr(), b.data_ptr(), h_out.data_ptr(),
                   c_out.data_ptr(), bsz, i_dim, h_dim, dtypes, stream)
    if err:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error "
                           f"{err}")
    lstm_cell.launches += 1
    return h_out, c_out


lstm_cell.launches = 0


def _sequence_launch(xs, wx, wh, b, *, return_sequence: bool,
                     train: bool):
    """One launch of the sequence kernel. Returns (h_T, c_T, hs or None,
    gates, cs); with `train`, hs always and the training record gates
    (T, B, 4H) and cs (T, B, H), float32, else None for both."""
    build.check_card("lstm_sequence", xs)
    t_len, bsz, i_dim = xs.shape
    h_dim = wh.shape[0]
    if h_dim > MAX_SEQUENCE_HIDDEN:
        raise ValueError(f"hidden size {h_dim} exceeds the sequence "
                         f"kernel's {MAX_SEQUENCE_HIDDEN} (one thread per "
                         f"gate column)")
    h_floats = max(-(-h_dim // 4) * 4, 32)
    if (h_floats + 4 * h_dim + _SEQ_TC * (i_dim + 4 * h_dim)) * 4 \
            > _SEQ_SMEM_CAP:
        raise ValueError(f"a segment of {_SEQ_TC} steps at I = {i_dim}, "
                         f"H = {h_dim} exceeds a block's shared memory")
    hs = xs.new_empty((t_len, bsz, h_dim)) \
        if return_sequence or train else None
    gates = cs = None
    if train:
        gates = xs.new_empty((t_len, bsz, 4 * h_dim), dtype=torch.float32)
        cs = xs.new_empty((t_len, bsz, h_dim), dtype=torch.float32)
    if t_len == 0 or bsz == 0 or h_dim == 0:
        return (xs.new_zeros((bsz, h_dim)), xs.new_zeros((bsz, h_dim)), hs,
                gates, cs)
    h_out = xs.new_empty((bsz, h_dim))
    c_out = xs.new_empty((bsz, h_dim))
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _sequence_entry()(xs.data_ptr(), wx.data_ptr(), wh.data_ptr(),
                            b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
                            ptr(hs), ptr(gates), ptr(cs), t_len, bsz, i_dim,
                            h_dim, int(xs.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"lstm_sequence kernel launch failed: CUDA error "
                           f"{err}")
    lstm_sequence.launches += 1
    return h_out, c_out, hs, gates, cs


class _LSTMSequence(torch.autograd.Function):
    """The sequence kernel under autograd: the forward launches its
    training instance, the backward `lstm_sequence_backward`."""

    @staticmethod
    def forward(ctx, xs, wx, wh, b):
        h, c, hs, gates, cs = _sequence_launch(xs, wx, wh, b,
                                               return_sequence=True,
                                               train=True)
        ctx.save_for_backward(xs, wx, wh, hs, gates, cs)
        # an output the loss does not reach comes back as None, not zeros
        ctx.set_materialize_grads(False)
        return h, c, hs

    @staticmethod
    def backward(ctx, dh, dc, dhs):
        xs, wx, wh, hs, gates, cs = ctx.saved_tensors
        # the first layer's xs are data: no dxs
        return lstm_sequence_backward(
            xs, wx, wh, hs, gates, cs, dh, dc, dhs,
            need_dxs=ctx.needs_input_grad[0])


def lstm_sequence(xs: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                  b: torch.Tensor, *, return_sequence: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor,
                             torch.Tensor | None]:
    """xs: (T, B, I); wx: (I, 4, H); wh: (H, 4, H); b: (4, H).

    T steps of `lstm_cell` from h = c = 0, gate order i, f, g, o; the
    inputs all float32 or all bfloat16, float32 math, h and c carried in
    the inputs' dtype. Returns (h_T, c_T, hs): hs is the (T, B, H) hidden
    sequence when `return_sequence`, else None. On the card: one launch,
    on the current CUDA stream, no synchronise; with grad enabled and an
    input that requires it, the launch is the training forward and the
    backward is `lstm_sequence_backward`."""
    _check_sequence(xs, wx, wh, b)
    if xs.device.type == "cpu":
        return lstm_sequence_plain(xs, wx, wh, b,
                                   return_sequence=return_sequence)
    if _wants_grad(xs, wx, wh, b):
        build.check_card("lstm_sequence", xs)
        h, c, hs = _LSTMSequence.apply(xs, wx, wh, b)
        return h, c, hs if return_sequence else None
    return _sequence_launch(xs, wx, wh, b, return_sequence=return_sequence,
                            train=False)[:3]


lstm_sequence.launches = 0


def lstm_sequence_train_plain(xs, wx, wh, b):
    """The training forward in plain PyTorch: `lstm_sequence_plain`'s scan
    that also returns the record the backward reads. Returns (h_T, c_T,
    hs, gates (T, B, 4H) the activated i, f, g, o, cs (T, B, H) each
    step's cell state before the rounding to the dtype), gates and cs
    float32."""
    f32 = torch.float32
    t_len, bsz, _ = xs.shape
    i_dim, _, h_dim = wx.shape
    wxf = wx.to(f32).reshape(i_dim, 4 * h_dim)
    whf = wh.to(f32).reshape(h_dim, 4 * h_dim)
    bf = b.to(f32).reshape(4 * h_dim)
    h = c = xs.new_zeros((bsz, h_dim))
    hs, gates, cs = [], [], []
    for xt in xs:
        pre = xt.to(f32) @ wxf + h.to(f32) @ whf + bf
        i, f, g, o = torch.chunk(pre, 4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c_new = f * c.to(f32) + i * g
        h = (o * torch.tanh(c_new)).to(xs.dtype)
        c = c_new.to(xs.dtype)
        hs.append(h)
        gates.append(torch.cat([i, f, g, o], dim=-1))
        cs.append(c_new)
    if not hs:
        return (h, c, xs.new_zeros((0, bsz, h_dim)),
                xs.new_zeros((0, bsz, 4 * h_dim), dtype=f32),
                xs.new_zeros((0, bsz, h_dim), dtype=f32))
    return h, c, torch.stack(hs), torch.stack(gates), torch.stack(cs)


def lstm_sequence_train(xs, wx, wh, b):
    """The training forward: `lstm_sequence` with `return_sequence` that
    also returns the record the backward reads, (h_T, c_T, hs, gates, cs)
    as `lstm_sequence_train_plain` gives them. One launch of the kernel on
    the card (counted in `lstm_sequence.launches`), the plain version on
    the CPU; no autograd."""
    _check_sequence(xs, wx, wh, b)
    if xs.device.type == "cpu":
        return lstm_sequence_train_plain(xs, wx, wh, b)
    return _sequence_launch(xs, wx, wh, b, return_sequence=True, train=True)


def _products(xs, wx, hs, dgates):
    """The plain version's products off the chain, from the
    pre-activation gate gradients dgates (T, B, 4H) float32: dxs = dG
    wx^T, dwx = sum_t x_t^T dG_t, dwh = sum_t h_{t-1}^T dG_t (h_{-1} = 0),
    db = sum_t dG_t; float32 matrix products over the T B rows, in the
    inputs' dtypes."""
    f32 = torch.float32
    t_len, bsz, i_dim = xs.shape
    h_dim = hs.shape[2]
    dg = dgates.reshape(t_len * bsz, 4 * h_dim)
    dxs = (dg @ wx.to(f32).reshape(i_dim, 4 * h_dim).t()).reshape(xs.shape)
    dwx = xs.reshape(-1, i_dim).to(f32).t() @ dg
    h_prev = torch.cat([hs.new_zeros((1, bsz, h_dim)), hs[:-1]])
    dwh = h_prev.reshape(-1, h_dim).to(f32).t() @ dg
    db = dg.sum(0)
    return (dxs.to(xs.dtype), dwx.reshape(i_dim, 4, h_dim).to(wx.dtype),
            dwh.reshape(h_dim, 4, h_dim).to(wx.dtype),
            db.reshape(4, h_dim).to(wx.dtype))


def lstm_sequence_backward_plain(xs, wx, wh, hs, gates, cs, dh=None,
                                 dc=None, dhs=None):
    """The backward kernels' function in plain PyTorch, written from the
    formulas (csrc/lstm_cell.cu, `lstm_bwd_fused_kernel`): the chain
    t = T-1 ... 0 over the training forward's record, then `_products`.
    dh, dc (B, H) and dhs (T, B, H) are the upstream gradients of h_T, c_T
    and hs (None: zero). float32 math; returns (dxs, dwx, dwh, db) in the
    inputs' dtypes."""
    f32 = torch.float32
    t_len, bsz, _ = xs.shape
    h_dim = wh.shape[0]
    whf = wh.to(f32).reshape(h_dim, 4 * h_dim)
    zero = xs.new_zeros((bsz, h_dim), dtype=f32)
    dh_next = zero if dh is None else dh.to(f32)
    dcar = zero if dc is None else dc.to(f32)
    dgates = torch.empty_like(gates)
    for t in range(t_len - 1, -1, -1):
        i, f, g, o = torch.chunk(gates[t], 4, dim=-1)
        c_prev = cs[t - 1].to(xs.dtype).to(f32) if t > 0 else zero
        up = zero if dhs is None else dhs[t].to(f32)
        d_h = dh_next + up
        tc = torch.tanh(cs[t])
        dcar = dcar + d_h * o * (1.0 - tc * tc)
        dg = torch.cat([dcar * g * i * (1.0 - i),
                        dcar * c_prev * f * (1.0 - f),
                        dcar * i * (1.0 - g * g),
                        d_h * tc * o * (1.0 - o)], dim=-1)
        dcar = dcar * f
        dgates[t] = dg
        dh_next = dg @ whf.t()
    return _products(xs, wx, hs, dgates)


def lstm_sequence_backward(xs: torch.Tensor, wx: torch.Tensor,
                           wh: torch.Tensor, hs: torch.Tensor,
                           gates: torch.Tensor, cs: torch.Tensor,
                           dh: torch.Tensor | None = None,
                           dc: torch.Tensor | None = None,
                           dhs: torch.Tensor | None = None, *,
                           need_dxs: bool = True):
    """The gradient of `lstm_sequence` at (xs, wx, wh, b), from the
    training forward's record (hs, gates, cs as `lstm_sequence_train`
    gives them) and the upstream gradients dh, dc (B, H) of h_T and c_T
    and dhs (T, B, H) of hs, each None for zero. Returns (dxs, dwx, dwh,
    db) in the inputs' dtypes; dxs None unless `need_dxs`. On the card:
    two launches, the fused chain and products, then the fixed-order sum
    of the batch rows' partials (a second call is bit-equal), counted once
    in `lstm_sequence_backward.launches`; no library call. On the CPU,
    `lstm_sequence_backward_plain`."""
    _check_sequence(xs, wx, wh, None)
    t_len, bsz, i_dim = xs.shape
    h_dim = wh.shape[0]
    upstream = {"dh": (dh, (bsz, h_dim)), "dc": (dc, (bsz, h_dim)),
                "dhs": (dhs, (t_len, bsz, h_dim))}
    ups = {}
    for name, (t, shape) in upstream.items():
        if t is not None:
            if t.shape != shape or t.device != xs.device:
                raise ValueError(f"{name} must be {shape} on {xs.device}")
            if t.dtype != xs.dtype or not t.is_contiguous():
                t = t.to(xs.dtype).contiguous()
        ups[name] = t
    if xs.device.type == "cpu":
        grads = lstm_sequence_backward_plain(xs, wx, wh, hs, gates, cs,
                                             **ups)
        return (grads[0] if need_dxs else None,) + grads[1:]
    build.check_card("lstm_sequence_backward", xs)
    for name, t, shape in (("hs", hs, (t_len, bsz, h_dim)),
                           ("gates", gates, (t_len, bsz, 4 * h_dim)),
                           ("cs", cs, (t_len, bsz, h_dim))):
        if t.shape != shape or t.device != xs.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape} on "
                             f"{xs.device}")
    if hs.dtype != xs.dtype:
        raise TypeError(f"hs must be {xs.dtype}")
    if gates.dtype != torch.float32 or cs.dtype != torch.float32:
        raise TypeError("gates and cs must be float32")
    if h_dim > MAX_SEQUENCE_HIDDEN:
        raise ValueError(f"hidden size {h_dim} exceeds the backward "
                         f"kernel's {MAX_SEQUENCE_HIDDEN}")
    dxs = torch.empty_like(xs) if need_dxs else None
    dwx, dwh = torch.empty_like(wx), torch.empty_like(wh)
    db = wx.new_empty((4, h_dim))
    if gates.numel() == 0:
        for t in (dxs, dwx, dwh, db):
            if t is not None:
                t.zero_()
        return dxs, dwx, dwh, db
    entry, ws_floats = _backward_entry()
    n_ws = ws_floats(bsz, i_dim, h_dim)
    # the batch rows' partial [dwx; dwh; db], summed by the second launch
    ws = torch.empty(n_ws, dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream().cuda_stream  # xs's, checked above
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = entry(xs.data_ptr(), wx.data_ptr(), wh.data_ptr(), hs.data_ptr(),
                gates.data_ptr(), cs.data_ptr(), ptr(ups["dhs"]),
                ptr(ups["dh"]), ptr(ups["dc"]), ptr(dxs), dwx.data_ptr(),
                dwh.data_ptr(), db.data_ptr(), ws.data_ptr(), n_ws, t_len,
                bsz, i_dim, h_dim, int(xs.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"lstm_sequence_backward kernel launch failed: "
                           f"CUDA error {err}")
    lstm_sequence_backward.launches += 1
    return dxs, dwx, dwh, db


lstm_sequence_backward.launches = 0
