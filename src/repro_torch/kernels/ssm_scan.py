"""Mamba2 selective-state-space scan: hand-written CUDA kernels, forward
and backward, and their plain versions.

Port of the Pallas TPU kernel `ssm_scan` (src/repro/kernels/ssm_scan.py):
one B/C group shared by all heads, a float32 state from zero, y in x's
dtype and the final state in float32. The CUDA source, `csrc/ssm_scan.cu`,
says what bounds it on an H100 and how its design answers that: bf16
inputs take the Pallas kernel's chunked form on the tensor cores, in
chunks of 64 steps; float32 inputs take the recurrence step by step on
the CUDA cores. Both take any L, H and P, so `chunk` and `block_h` are
accepted for the signature and not used.

Training: on the card, `ssm_scan` under autograd is a
`torch.autograd.Function` whose forward launches the serving kernel as it
stands and whose backward is `ssm_scan_backward`, the hand-written
`csrc/ssm_scan_bwd.cu` (the Pallas kernel has no backward; the reference
differentiates its scan by autodiff): on bf16 inputs the chunked (SSD)
form on the tensor cores, on float32 the sequential reverse scan on the
CUDA cores. The backward recomputes the states
itself rather than have the forward store them. Its plain version,
`ssm_scan_backward_plain`, is written from the formulas; nothing on the
card's path runs a plain version.

Each wrapper takes its kernel for CUDA tensors and its plain PyTorch
version for CPU tensors (where autograd differentiates the plain scan);
on the card it launches the kernel or raises. They count their launches
in `ssm_scan.launches` and `ssm_scan_backward.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE_DIM = 128


def ssm_scan_plain(x, dt, a, b, c, d, *, chunk: int = 256,
                   block_h: int = 8):
    """The kernel's function in plain PyTorch: the sequential
    `ref.ssm_scan_reference` from a zero state."""
    return ref.ssm_scan_reference(x, dt, a, b, c, d)


def _check(x, dt, a, b, c, d) -> None:
    for name, t, nd in (("x", x, 4), ("dt", dt, 3), ("a", a, 1),
                        ("b", b, 3), ("c", c, 3), ("d", d, 1)):
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {t.dim()}")
    bsz, l, h, _ = x.shape
    n = b.shape[-1]
    if dt.shape != (bsz, l, h):
        raise ValueError(f"dt shape {tuple(dt.shape)} != {(bsz, l, h)}")
    if a.shape != (h,) or d.shape != (h,):
        raise ValueError(f"a {tuple(a.shape)} and d {tuple(d.shape)} must "
                         f"both be {(h,)}")
    if b.shape != (bsz, l, n) or c.shape != (bsz, l, n):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"both be (B={bsz}, L={l}, N)")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("ssm_scan takes x, b, c of one dtype, float32 or "
                        f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, a, d)):
        raise TypeError("ssm_scan takes dt, a, d in float32, got "
                        f"{dt.dtype}, {a.dtype}, {d.dtype}")
    tensors = (x, dt, a, b, c, d)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssm_scan inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("ssm_scan").repro_ssm_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_entries():
    lib = build.load("ssm_scan_bwd")
    size = lib.repro_ssm_scan_bwd_workspace
    size.argtypes = [ctypes.c_int] * 6
    size.restype = ctypes.c_longlong
    fn = lib.repro_ssm_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return size, fn



def _forward(x, dt, a, b, c, d):
    """One launch of the forward kernel: (y, final state)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if n > MAX_STATE_DIM:
        raise ValueError(f"state dim N={n} exceeds the kernel's "
                         f"{MAX_STATE_DIM}")
    y = torch.empty_like(x)
    if x.numel() == 0 or n == 0:      # nothing to scan: the zero state
        return y, torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                   c.data_ptr(), d.data_ptr(), y.data_ptr(),
                   state.data_ptr(), _DTYPES[x.dtype], bsz, l, h, p, n,
                   stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error "
                           f"{err}")
    ssm_scan.launches += 1
    return y, state


class _SsmScan(torch.autograd.Function):
    """The kernel under autograd: the forward launches the forward kernel,
    the backward `ssm_scan_backward`'s kernels. A cotangent that autograd
    leaves out (the final state of a loss that drops it) stays None,
    which the backward takes as zero."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c, d)
        return _forward(x, dt, a, b, c, d)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, d = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return ssm_scan_backward(x, dt, a, b, c, d, dy.contiguous(),
                                 None if dstate is None
                                 else dstate.contiguous())


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 256,
             block_h: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H) (post-softplus, > 0); a: (H,) (< 0);
    b, c: (B, L, N) (single group shared across heads); d: (H,).
    Returns (y (B, L, H, P), final_state (B, H, P, N) float32). Launches
    on the current CUDA stream and does not synchronise. With grad
    enabled and an input that requires it, the backward launches
    `ssm_scan_backward`'s kernels; the forward launch is the same
    either way."""
    _check(x, dt, a, b, c, d)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, a, b, c, d)
    build.check_card("ssm_scan", x)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c, d)):
        return _SsmScan.apply(x, dt, a, b, c, d)
    return _forward(x, dt, a, b, c, d)


ssm_scan.launches = 0


def ssm_states_plain(x, dt, a, b):
    """The states the backward recomputes: h_{t-1} of every step t (the
    state before it; h_{-1} = 0), float32 (B, H, P, N) each."""
    f32 = torch.float32
    bsz, l, h, p = x.shape
    dtf = dt.to(f32)
    decay = torch.exp(dtf * a.to(f32))
    upd = x.to(f32) * dtf[..., None]
    bf = b.to(f32)
    state = x.new_zeros((bsz, h, p, b.shape[-1]), dtype=f32)
    prev = []
    for t in range(l):
        prev.append(state)
        state = (state * decay[:, t, :, None, None]
                 + torch.einsum("bhp,bn->bhpn", upd[:, t], bf[:, t]))
    return prev


def ssm_scan_backward_plain(x, dt, a, b, c, d, dy, dstate=None):
    """The backward kernel's function in plain PyTorch, written from the
    formulas (csrc/ssm_scan_bwd.cu). With h_t the state after step t
    (h_{-1} = 0), e_t = exp(dt_t a) and the reverse scan
        dh_t = dy_t (x) C_t + e_{t+1} dh_{t+1},   dh_{L-1} starting from
        the final state's cotangent `dstate` (None: zero),
    the gradients are
        dx_t = D dy_t + dt_t dh_t B_t
        ddt_t = sum_{p,n} dh_t (a e_t h_{t-1} + x_t (x) B_t)
        da = sum_t dt_t e_t sum dh_t h_{t-1}
        dB_t = sum_{h,p} dt_t x_t dh_t,   dC_t = sum_{h,p} dy_t h_t
        dD = sum dy x.
    float32 math; returns (dx, ddt, da, db, dc, dd), dx, db and dc in
    x's dtype, the others float32."""
    f32 = torch.float32
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf, dyf = (t.to(f32) for t in (x, dt, b, c, dy))
    af = a.to(f32)
    decay = torch.exp(dtf * af)                               # (B, L, H)
    upd = xf * dtf[..., None]                                 # (B, L, H, P)
    prev = ssm_states_plain(x, dt, a, b)
    dh = (x.new_zeros((bsz, h, p, n), dtype=f32) if dstate is None
          else dstate.to(f32).clone())
    dxs, ddt, db, dc = (torch.empty_like(t) for t in (xf, dtf, bf, cf))
    da = x.new_zeros((h,), dtype=f32)
    for t in range(l - 1, -1, -1):
        hp, e = prev[t], decay[:, t]
        ht = hp * e[..., None, None] + torch.einsum("bhp,bn->bhpn",
                                                    upd[:, t], bf[:, t])
        dh = dh + torch.einsum("bhp,bn->bhpn", dyf[:, t], cf[:, t])
        dc[:, t] = torch.einsum("bhpn,bhp->bn", ht, dyf[:, t])
        db[:, t] = torch.einsum("bhpn,bhp->bn", dh, upd[:, t])
        dxs[:, t] = dtf[:, t, :, None] * torch.einsum("bhpn,bn->bhp", dh,
                                                      bf[:, t])
        dh_hp = torch.einsum("bhpn,bhpn->bh", dh, hp)
        ddt[:, t] = (af * e * dh_hp
                     + torch.einsum("bhpn,bhp,bn->bh", dh, xf[:, t],
                                    bf[:, t]))
        da = da + (dtf[:, t] * e * dh_hp).sum(0)
        dh = dh * e[..., None, None]
    dx = dxs + dyf * d.to(f32)[None, None, :, None]
    dd = (dyf * xf).sum((0, 1, 3))
    return (dx.to(x.dtype), ddt, da, db.to(b.dtype), dc.to(c.dtype), dd)


def ssm_scan_backward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                      dy: torch.Tensor, dstate: torch.Tensor | None = None):
    """The gradient of `ssm_scan` at (x, dt, a, b, c, d): dy the gradient
    of y (x's shape and dtype, contiguous), dstate that of the final state
    ((B, H, P, N) float32, contiguous) or None for zero. Returns (dx, ddt,
    da, db, dc, dd) as `ssm_scan_backward_plain` gives them. On the card:
    one call of `csrc/ssm_scan_bwd.cu`, no atomics, counted once in
    `ssm_scan_backward.launches`: bf16 takes the chunked form on the
    tensor cores (four launches: every chunk's local states, the passes
    along the chunks, every chunk's gradients with per-block partial sums,
    their reduction), float32 the sequential reverse scan on the CUDA
    cores (two launches: the scan, which writes dx and per-block partial
    sums, and their reduction); on the CPU, `ssm_scan_backward_plain`."""
    _check(x, dt, a, b, c, d)
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} tensor of x's "
                         f"shape {tuple(x.shape)} on {x.device}")
    if dstate is not None and (
            dstate.shape != (bsz, h, p, n) or dstate.dtype != torch.float32
            or dstate.device != x.device or not dstate.is_contiguous()):
        raise ValueError(f"dstate must be contiguous float32 "
                         f"{(bsz, h, p, n)} on {x.device}")
    if x.device.type == "cpu":
        return ssm_scan_backward_plain(x, dt, a, b, c, d, dy, dstate)
    build.check_card("ssm_scan_backward", x)
    if n > MAX_STATE_DIM:
        raise ValueError(f"state dim N={n} exceeds the kernel's "
                         f"{MAX_STATE_DIM}")
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da, dd = torch.empty_like(a), torch.empty_like(d)
    if x.numel() == 0 or n == 0:
        return (dx.copy_(dy * d[None, None, :, None]), ddt.zero_(),
                da.zero_(), db.zero_(), dc.zero_(),
                (dy.float() * x.float()).sum((0, 1, 3)))
    size, fn = _backward_entries()
    work = torch.empty(size(_DTYPES[x.dtype], bsz, l, h, p, n),
                       dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
             c.data_ptr(), d.data_ptr(), dy.data_ptr(),
             None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
             ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
             dd.data_ptr(), work.data_ptr(), _DTYPES[x.dtype], bsz, l, h, p,
             n, stream)
    if err:
        raise RuntimeError(f"ssm_scan_backward kernel launch failed: CUDA "
                           f"error {err}")
    ssm_scan_backward.launches += 1
    return dx, ddt, da, db, dc, dd


ssm_scan_backward.launches = 0
