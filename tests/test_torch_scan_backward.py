"""Gradients of the two scans on the CPU against the JAX reference: the
plain versions of the port's backward kernels for `ssm_scan` and
`mlstm_chunk` (`ssm_scan_backward_plain`, `mlstm_chunk_backward_plain`,
written from the formulas, which the card's kernels are held to in
tests/test_torch_cuda.py and chip_smoke.py) against `jax.grad` of the
reference's oracles and against torch.autograd of the port's plain
forwards, with cotangents on y and on the final state; and the states the
backward recomputes against the forward's.

Tolerances (float32): ssm_scan 1e-4 absolute + relative (the same float32
products, summed in another order over P x N per step and over L steps);
mlstm_chunk 5e-4 absolute and 5e-3 relative, the forward's bars
(tests/test_kernels.py), against the chunkwise `mlstm_chunk_jnp` at chunk
64 and the sequential `mlstm_chunk_reference` alike (one function: the
stabiliser m is the same whatever the chunk). bf16 inputs take float32
math on both sides and round the gradients of the bf16 inputs once: 2e-2.
The reduced zamba2 and xlstm losses are held to the reference in
tests/test_torch_backward.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import mlstm_chunk as mk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as sk

SSM_TOL = 1e-4
MLSTM_ATOL, MLSTM_RTOL = 5e-4, 5e-3
BF16_TOL = 2e-2

# (b, l, h, p, n): N in {16, 64}, P in {8, 24}, ragged L (not a multiple
# of the kernel's segments), L = 1
SSM_CASES = [(2, 37, 3, 8, 16), (1, 70, 2, 24, 64), (2, 16, 2, 24, 16),
             (1, 1, 2, 8, 64)]


def _ssm_inputs(shape, seed):
    b, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return [x, dt, a, bm, cm, d], dy, dstate


SSM_NAMES = ("dx", "ddt", "da", "db", "dc", "dd")


@pytest.mark.parametrize("shape", SSM_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_backward_plain_matches_jax_grad(shape):
    """The gradient of sum(y dy) + sum(h_L dstate) through the
    reference's sequential `ssm_scan_reference`."""
    args, dy, dstate = _ssm_inputs(shape, sum(shape))

    def loss(*a):
        y, state = jref.ssm_scan_reference(*a)
        return jnp.sum(y * dy) + jnp.sum(state * dstate)

    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    got = sk.ssm_scan_backward(*map(torch.as_tensor, args),
                               torch.as_tensor(dy), torch.as_tensor(dstate))
    for name, g, w in zip(SSM_NAMES, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSM_TOL,
                                   rtol=SSM_TOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("which", ["y", "state", "both"])
def test_ssm_backward_plain_matches_autograd(which, dtype):
    """Each cotangent alone (the other None, a zero cotangent) and both,
    against torch.autograd of `ssm_scan_plain`; bf16 x, b, c, dy with
    float32 math, dx, db, dc in bf16."""
    shape = (2, 21, 2, 24, 16)
    arrays, dy, dstate = _ssm_inputs(shape, 7)
    ts = [torch.as_tensor(a) for a in arrays]
    for j in (0, 3, 4):
        ts[j] = ts[j].to(dtype)
    dy_t = torch.as_tensor(dy).to(dtype)
    ds_t = torch.as_tensor(dstate)
    leaves = [t.clone().requires_grad_() for t in ts]
    y, state = sk.ssm_scan_plain(*leaves)
    loss = 0.0
    if which in ("y", "both"):
        loss = loss + (y.float() * dy_t.float()).sum()
    if which in ("state", "both"):
        loss = loss + (state * ds_t).sum()
    want = torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)
    got = sk.ssm_scan_backward_plain(
        *ts, dy_t if which != "state" else torch.zeros_like(dy_t),
        ds_t if which != "y" else None)
    tol = SSM_TOL if dtype == torch.float32 else BF16_TOL
    for name, g, w in zip(SSM_NAMES, got, want):
        assert g.dtype == w.dtype, name
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=name)


def test_ssm_backward_recomputes_the_forward_states():
    """The states the backward recomputes (h_{t-1} of every step) are the
    forward's: h_{t-1} equals the oracle's final state over the first t
    steps, and the last step's update gives the forward's final state."""
    shape = (2, 19, 2, 8, 16)
    args = [torch.as_tensor(a) for a in _ssm_inputs(shape, 3)[0]]
    x, dt, a, bm, cm, d = args
    prev = sk.ssm_states_plain(x, dt, a, bm)
    assert len(prev) == shape[1]
    for t in (1, 7, 18):
        _, want = tref.ssm_scan_reference(x[:, :t], dt[:, :t], a, bm[:, :t],
                                          cm[:, :t], d)
        torch.testing.assert_close(prev[t], want, atol=1e-5, rtol=1e-5)
    _, final = sk.ssm_scan_plain(*args)
    e = torch.exp(dt[:, -1] * a)
    last = (prev[-1] * e[..., None, None]
            + torch.einsum("bhp,bn->bhpn", x[:, -1] * dt[:, -1, :, None],
                           bm[:, -1]))
    torch.testing.assert_close(last, final, atol=1e-5, rtol=1e-5)


# (b, l, h, d, input-gate shift): L a multiple of the chunk, ragged L,
# L < 64, and a negative input gate, where exp(-m) wins the denominator
# in the first steps
MLSTM_CASES = [(2, 128, 2, 16, 0.0), (1, 100, 2, 32, 0.0),
               (2, 40, 2, 8, -3.0), (1, 130, 1, 16, -3.0)]


def _mlstm_inputs(case, seed):
    b, l, h, d, shift = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32)
               for _ in range(3))
    ig = (rng.standard_normal((b, l, h)) + shift).astype(np.float32)
    fg = (rng.standard_normal((b, l, h)) + 2.0).astype(np.float32)
    dy = rng.standard_normal((b, l, h, d)).astype(np.float32)
    state = (rng.standard_normal((b, h, d, d)).astype(np.float32),
             rng.standard_normal((b, h, d)).astype(np.float32),
             rng.standard_normal((b, h)).astype(np.float32))
    return [q, k, v, ig, fg], dy, state


def _exp_wins(args):
    """Steps where exp(-m) > |q . n| in the sequential oracle's terms."""
    q, k, _, ig, fg = (torch.as_tensor(a) for a in args)
    d = q.shape[-1]
    n = torch.zeros(q.shape[0], q.shape[2], d)
    m = torch.full(q.shape[:1] + q.shape[2:3], tref.NEG_INF)
    wins = []
    for t in range(q.shape[1]):
        log_f = torch.nn.functional.logsigmoid(fg[:, t])
        m_new = torch.maximum(log_f + m, ig[:, t])
        n = (n * torch.exp(log_f + m - m_new)[..., None]
             + torch.exp(ig[:, t] - m_new)[..., None] * k[:, t] / d ** 0.5)
        wins.append(torch.exp(-m_new) > (n * q[:, t]).sum(-1).abs())
        m = m_new
    return torch.stack(wins)


MLSTM_NAMES = ("dq", "dk", "dv", "di", "df")


@pytest.mark.parametrize("oracle", ["chunkwise", "sequential"])
@pytest.mark.parametrize("case", MLSTM_CASES, ids=str)
def test_mlstm_backward_plain_matches_jax_grad(case, oracle):
    """The gradient of sum(y dy) + sum(C dC) + sum(n dn) + sum(m dm)
    through the reference's `mlstm_chunk_jnp` at chunk 64 (which takes the
    sequential oracle where 64 does not divide L) and through
    `mlstm_chunk_reference`."""
    args, dy, (dc, dn, dm) = _mlstm_inputs(case, sum(case[:4]))
    if case[4] < 0:
        assert bool(_exp_wins(args).any())

    def loss(*a):
        if oracle == "chunkwise":
            y, (c, n, m) = jref.mlstm_chunk_jnp(*a, chunk=64)
        else:
            y, (c, n, m) = jref.mlstm_chunk_reference(*a)
        return (jnp.sum(y * dy) + jnp.sum(c * dc) + jnp.sum(n * dn)
                + jnp.sum(m * dm))

    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    got = mk.mlstm_chunk_backward(
        *map(torch.as_tensor, args), torch.as_tensor(dy),
        *map(torch.as_tensor, (dc, dn, dm)))
    for name, g, w in zip(MLSTM_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MLSTM_ATOL,
                                   rtol=MLSTM_RTOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("which", ["y", "state", "all"])
def test_mlstm_backward_plain_matches_autograd(which, dtype):
    """Cotangents on y alone, on (C, n, m) alone (None for the others)
    and on all four, against torch.autograd of `mlstm_chunk_plain`, with
    the exp(-m) branch live; bf16 q, k, v, dy with float32 math."""
    case = (2, 90, 2, 16, -3.0)
    args, dy, state = _mlstm_inputs(case, 11)
    assert bool(_exp_wins(args).any())
    ts = [torch.as_tensor(a) for a in args]
    for j in range(3):
        ts[j] = ts[j].to(dtype)
    dy_t = torch.as_tensor(dy).to(dtype)
    st = [torch.as_tensor(s) for s in state]
    leaves = [t.clone().requires_grad_() for t in ts]
    y, outs = mk.mlstm_chunk_plain(*leaves)
    loss = 0.0
    if which in ("y", "all"):
        loss = loss + (y.float() * dy_t.float()).sum()
    if which in ("state", "all"):
        loss = loss + sum((o * s).sum() for o, s in zip(outs, st))
    want = torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)
    got = mk.mlstm_chunk_backward_plain(
        *ts, dy_t if which != "state" else torch.zeros_like(dy_t),
        *(st if which != "y" else (None, None, None)))
    for name, g, w in zip(MLSTM_NAMES, got, want):
        assert g.dtype == w.dtype, name
        if dtype == torch.bfloat16 and g.dtype == torch.bfloat16:
            tol = (BF16_TOL, BF16_TOL)
        else:
            tol = (MLSTM_ATOL, MLSTM_RTOL)
        torch.testing.assert_close(g.float(), w.float(), atol=tol[0],
                                   rtol=tol[1], msg=name)


def test_mlstm_backward_recomputes_the_forward_states():
    """The chunk states the backward recomputes, (C, n, m) entering each
    chunk of 64, are the sequential oracle's after that many steps, and
    the last chunk's update gives the forward's final state."""
    case = (1, 150, 2, 16, 0.0)
    q, k, v, ig, fg = (torch.as_tensor(a)
                       for a in _mlstm_inputs(case, 5)[0])
    starts = mk.mlstm_chunk_states_plain(q, k, v, ig, fg)
    assert [c0 for c0, *_ in starts] == [0, 64, 128]
    for c0, c_in, n_in, m_in in starts[1:]:
        _, (c, n, m) = tref.mlstm_chunk_reference(
            q[:, :c0], k[:, :c0], v[:, :c0], ig[:, :c0], fg[:, :c0])
        for got, want in ((c_in, c), (n_in, n), (m_in, m)):
            torch.testing.assert_close(got, want, atol=MLSTM_ATOL,
                                       rtol=MLSTM_RTOL)
    _, final = mk.mlstm_chunk_plain(q, k, v, ig, fg)
    _, c_fin, n_fin, m_fin = mk.mlstm_chunk_states_plain(
        q, k, v, ig, fg, final=True)[-1]
    for got, want in zip((c_fin, n_fin, m_fin), final):
        torch.testing.assert_close(got, want, atol=MLSTM_ATOL,
                                   rtol=MLSTM_RTOL)
