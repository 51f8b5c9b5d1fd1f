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
import functools

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


# --- the bf16 tensor-core designs of csrc/ssm_scan_bwd.cu and
# csrc/mlstm_chunk_bwd.cu, modelled on the CPU --------------------------
# Each model is the kernel's algebra in plain torch (float32 sums of exact
# bf16 products) on bf16-valued inputs, every float32 operand fed to a
# product as the kernel feeds it: bf16 hi + lo (two products, ~16 bits)
# or, where named in `once`, rounded to bf16 once. It is held against
# jax.grad of the reference's oracle at the bars chip_smoke.py holds the
# kernels to against their plain versions: the bf16 gradients within
# 2e-2 absolute and relative with every row within 1e-2 of its norm (a
# row's norm taken as at least a tenth of the mean row norm), the float32
# ones within 1e-4 relative and 1e-4 of their largest entry (at least 1)
# absolute. The `once` cases show why each split is kept: rounded once,
# that operand misses a bar.
CARD_BF16_TOL, CARD_ROW_REL, CARD_F32_TOL = 2e-2, 1e-2, 1e-4
TC = 64


def _bf16(t):
    """t rounded to bf16 once, kept in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _hilo(t):
    """t as the sum of its bf16 hi and lo parts."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _card_bars(got, want, bf16):
    """Whether each gradient meets the card's bar (want from JAX, rounded
    to bf16 where the kernel writes bf16)."""
    ok = []
    for g, w, is_bf16 in zip(got, want, bf16):
        w = torch.from_numpy(np.array(w))
        if is_bf16:
            w = _bf16(w)
            gap, size = (g - w).norm(dim=-1), w.norm(dim=-1)
            ok.append(torch.allclose(g, w, atol=CARD_BF16_TOL,
                                     rtol=CARD_BF16_TOL)
                      and bool((gap <= CARD_ROW_REL * torch.clamp(
                          size, min=0.1 * size.mean())).all()))
        else:
            atol = CARD_F32_TOL * max(1.0, float(w.abs().max()))
            ok.append(torch.allclose(g, w, atol=atol, rtol=CARD_F32_TOL))
    return ok


@pytest.fixture
def one_thread():
    """The models are long chains of tensor ops: one thread keeps each
    test process from contending with the other test workers for the
    cores. Restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SSM_SPLITS = ("w", "z", "m", "hin", "dho", "dg")


def _ssm_tc_model(x, dt, a, bm, cm, d, dy, dstate=None, once=()):
    """csrc/ssm_scan_bwd.cu's bf16 design. Per chunk of 64 steps and head
    (a ragged last chunk padded with dt = 0, x = B = C = dy = 0), s =
    cumsum(dt a), S = s_{T-1}: the local states W^T B (W_u = dt_u x_u
    exp(S - s_u)) and Z = (exp(s) dy)^T C, passed along the chunks into
    h_in and dh_out; then dM = dy x^T, K = C B^T exp(s_t - s_u) [u <= t],
    M = K dt_u, dx = M^T dy + dt_u exp(S - s_u) (B dh_out^T)_u + D dy,
    dG = sum_heads dM exp(s_t - s_u) dt_u, dC = dG B + sum_heads exp(s_t)
    dy_t h_in, dB = dG^T C + sum_heads W dh_out, and ds_t from those terms,
    reverse-cumsummed into ddt and da. Split operands ("w", "z", "m",
    "hin", "dho", "dg": W, exp(s) dy, M, h_in, dh_out, dG) go in as hi +
    lo, or once. Returns (dx, ddt, da, db, dc, dd), dx, db, dc rounded to
    bf16."""
    part = {key: _bf16 if key in once else _hilo for key in SSM_SPLITS}
    bsz, l, h, p = x.shape
    n = bm.shape[-1]
    nc = -(-l // TC)

    def pad(t):
        out = t.new_zeros((bsz, nc * TC) + t.shape[2:])
        out[:, :l] = t
        return out.reshape((bsz, nc, TC) + t.shape[2:])
    xc, dtc, bc, cc, dyc = map(pad, (x, dt, bm, cm, dy))
    s = torch.cumsum(dtc * a, dim=2)                            # (B,C,T,H)
    es, e_s = torch.exp(s), torch.exp(s[:, :, -1])
    e_ss = torch.exp(s[:, :, -1:] - s)
    w = (dtc * e_ss)[..., None] * xc
    hloc = torch.einsum("bcuhp,bcun->bchpn", part["w"](w), bc)
    zloc = torch.einsum("bcthp,bctn->bchpn", part["z"](es[..., None] * dyc),
                        cc)
    hin, dho = torch.zeros(2, bsz, nc, h, p, n)
    state = torch.zeros(bsz, h, p, n)
    for c in range(nc):
        hin[:, c] = state
        state = e_s[:, c, :, None, None] * state + hloc[:, c]
    state = torch.zeros(bsz, h, p, n) if dstate is None else dstate
    for c in range(nc - 1, -1, -1):
        dho[:, c] = state
        state = e_s[:, c, :, None, None] * state + zloc[:, c]
    e0 = e_s * (_hilo(dho) * _hilo(hin)).sum((-1, -2))          # (B,C,H)
    hin_op, dho_op = part["hin"](hin), part["dho"](dho)
    causal = torch.tril(torch.ones(TC, TC, dtype=torch.bool))
    dec = torch.where(causal[None, None, :, :, None],
                      torch.exp(s[:, :, :, None] - s[:, :, None]), 0.0)
    kk = torch.einsum("bctn,bcun->bctu", cc, bc)[..., None] * dec
    dm = torch.einsum("bcthp,bcuhp->bctuh", dyc, xc)
    mm = kk * dtc[:, :, None]
    rb = torch.einsum("bcun,bchpn->bcuhp", bc, dho_op)
    dx = (torch.einsum("bctuh,bcthp->bcuhp", part["m"](mm), dyc)
          + (dtc * e_ss)[..., None] * rb + d[:, None] * dyc)
    q = e_ss * (xc * rb).sum(-1)
    y0 = es * (dyc * torch.einsum("bctn,bchpn->bcthp", cc, hin_op)).sum(-1)
    dg = part["dg"]((dm * dec * dtc[:, :, None]).sum(-1))
    dc = (torch.einsum("bctu,bcun->bctn", dg, bc)
          + torch.einsum("bcth,bcthp,bchpn->bctn", es, dyc, hin_op))
    db = (torch.einsum("bctu,bctn->bcun", dg, cc)
          + torch.einsum("bcuh,bcuhp,bchpn->bcun", dtc * e_ss, xc, dho_op))
    colk = (dm * kk).sum(2)
    ds = y0 + (dm * mm).sum(3) - dtc * (colk + q)
    ds[:, :, -1] += e0 + (dtc * q).sum(2)
    dl = torch.flip(torch.cumsum(torch.flip(ds, [2]), 2), [2])

    def unpad(t):
        return t.reshape((bsz, nc * TC) + t.shape[3:])[:, :l]
    return (_bf16(unpad(dx)), unpad(colk + q + a * dl),
            (dtc * dl).sum((0, 1, 2)), _bf16(unpad(db)), _bf16(unpad(dc)),
            (dyc * xc).sum((0, 1, 2, 4)))


@functools.lru_cache(maxsize=None)
def _ssm_tc_case(shape, seed, with_state):
    """bf16-valued inputs (x, B, C, dy) and jax.grad of the reference's
    sequential scan on them."""
    args, dy, dstate = _ssm_inputs(shape, seed)
    for j in (0, 3, 4):
        args[j] = _bf16(torch.from_numpy(args[j])).numpy()
    dy = _bf16(torch.from_numpy(dy)).numpy()
    dstate = dstate if with_state else None

    def loss(*a):
        y, state = jref.ssm_scan_reference(*a)
        out = jnp.sum(y * dy)
        return out if dstate is None else out + jnp.sum(state * dstate)
    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    return args, dy, dstate, want


def _ssm_tc_bars(shape, seed, with_state, once=()):
    args, dy, dstate, want = _ssm_tc_case(shape, seed, with_state)
    got = _ssm_tc_model(*map(torch.from_numpy, args), torch.from_numpy(dy),
                        None if dstate is None else torch.from_numpy(dstate),
                        once=once)
    return _card_bars(got, want, (True, False, False, True, True, False))


# zamba2's head shape (P = N = 64) at 8 of its 80 heads over 512 steps,
# and chip_smoke.py's ragged SSM_GRAD_CASES
SSM_TC_CASES = [(1, 512, 8, 64, 64), (2, 37, 3, 24, 20), (1, 70, 5, 80, 128)]


@pytest.mark.parametrize("with_state", [True, False], ids=["state", "y"])
@pytest.mark.parametrize("shape", SSM_TC_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_tensor_core_model_meets_the_card_bars(shape, with_state,
                                                   one_thread):
    assert all(_ssm_tc_bars(shape, 0, with_state)), SSM_NAMES


@pytest.mark.parametrize("once", SSM_SPLITS)
def test_one_rounding_of_an_ssm_backward_operand_misses_the_bars(
        once, one_thread):
    """Why each float32 operand of the SSD backward takes two products:
    rounded to bf16 once, W, exp(s) dy, h_in or dh_out miss the float32
    ddt's bar, M misses dx's rows, dG dB's and dC's."""
    shape = SSM_TC_CASES[0]
    assert all(_ssm_tc_bars(shape, 0, True))
    assert not all(_ssm_tc_bars(shape, 0, True, once=(once,)))


MLSTM_SPLITS = ("c", "s", "kw", "dnum", "dc", "iq", "dqk")


def _mlstm_tc_model(q, k, v, ig, fg, dy, dc=None, dn=None, dm=None,
                    once=()):
    """csrc/mlstm_chunk_bwd.cu's bf16 design, written from
    `mlstm_chunk_backward_plain` with the kernel's operands: q, k, v, dy
    exact; C and dC carried as hi + lo pairs (rounded after every update,
    "c", "dc"), S = (q k~^T) w ("s"), k w_out / sqrt(D) in C's update
    ("kw"), dnum = dy / den ("dnum"), inter q in dC's ("iq") and dS w
    ("dqk") fed as hi + lo, or once where named in `once`; n and dn
    updated in float32. Returns (dq, dk, dv) rounded to bf16 and (di,
    df)."""
    part = {key: _bf16 if key in once else _hilo for key in MLSTM_SPLITS}
    f32 = torch.float32
    bsz, l, h, d = q.shape
    scale = 1.0 / d ** 0.5
    c_in = torch.zeros(bsz, h, d, d)
    n_in = torch.zeros(bsz, h, d)
    m_in = torch.full((bsz, h), tref.NEG_INF)
    states = []
    for c0 in range(0, l, TC):
        sl = slice(c0, min(c0 + TC, l))
        states.append((c0, c_in, n_in, m_in))
        r = mk._chunk_record(q[:, sl], k[:, sl] * scale, v[:, sl], ig[:, sl],
                             fg[:, sl], c_in, n_in, m_in)
        kw = k[:, sl] * scale * r["w_out"][..., None]
        c_in = part["c"](c_in * r["carry"][..., None, None]
                         + torch.einsum("bthd,bthe->bhde", part["kw"](kw),
                                        v[:, sl]))
        n_in = n_in * r["carry"][..., None] + kw.sum(1)
        m_in = r["m_last"]
    d_c = part["dc"](torch.zeros(bsz, h, d, d) if dc is None else dc)
    d_n = torch.zeros(bsz, h, d) if dn is None else dn.clone()
    d_m = torch.zeros(bsz, h) if dm is None else dm.clone()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, df = torch.empty_like(ig), torch.empty_like(fg)
    for c0, c_in, n_in, m_in in reversed(states):
        sl = slice(c0, min(c0 + TC, l))
        qc, kc, vc, dyc, fc = (t[:, sl] for t in (q, k, v, dy, fg))
        r = mk._chunk_record(qc, kc * scale, vc, ig[:, sl], fc, c_in, n_in,
                             m_in)
        s_op = part["s"](r["s"])
        num = (torch.einsum("btuh,buhe->bthe", s_op, vc)
               + torch.einsum("bthd,bhde->bthe", qc, c_in)
               * r["inter"][..., None])
        qn, em, inter, w_out, carry = (r[x] for x in ("qn", "em", "inter",
                                                      "w_out", "carry"))
        den = torch.maximum(qn.abs(), em)
        dnum = part["dnum"](dyc / den[..., None])
        dden = -(dyc * num).sum(-1) / den ** 2
        qn_wins = (qn.abs() > em).to(f32) + 0.5 * (qn.abs() == em).to(f32)
        dqn = dden * torch.sign(qn) * qn_wins
        dmt = -dden * em * (1.0 - qn_wins)
        dmt[:, -1] += d_m
        ds = torch.where(r["causal"],
                         torch.einsum("bthe,buhe->btuh", dyc, vc)
                         / den[:, :, None] + dqn[:, :, None], 0.0)
        dqk = ds * r["w"]
        dqk_op = part["dqk"](dqk)
        c_dnum = (torch.einsum("bhde,bthe->bthd", c_in, dyc)
                  / den[..., None] + dqn[..., None] * n_in[:, None])
        dc_v = torch.einsum("bhde,buhe->buhd", d_c, vc) + d_n[:, None]
        dq[:, sl] = (torch.einsum("btuh,buhd->bthd", dqk_op, kc) * scale
                     + inter[..., None] * c_dnum)
        dk[:, sl] = (torch.einsum("btuh,bthd->buhd", dqk_op, qc)
                     + w_out[..., None] * dc_v) * scale
        dv[:, sl] = (torch.einsum("btuh,bthe->buhe", s_op, dnum)
                     + w_out[..., None] * scale
                     * torch.einsum("bhde,buhd->buhe", d_c, kc))
        dw = ds * r["s"]
        d_inter = (qc * c_dnum).sum(-1) * inter
        d_wout = (kc * scale * dc_v).sum(-1) * w_out
        d_carry = ((c_in * d_c).sum((-2, -1))
                   + (n_in * d_n).sum(-1)) * carry
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
        iq = qc * inter[..., None]
        d_c = part["dc"](d_c * carry[..., None, None]
                         + torch.einsum("bthd,bthe->bhde", part["iq"](iq),
                                        dnum))
        d_n = (d_n * carry[..., None]
               + torch.einsum("bth,bthd->bhd", dqn, iq))
    return _bf16(dq), _bf16(dk), _bf16(dv), di, df


@functools.lru_cache(maxsize=None)
def _mlstm_tc_case(case, seed, with_state):
    args, dy, state = _mlstm_inputs(case, seed)
    for j in range(3):
        args[j] = _bf16(torch.from_numpy(args[j])).numpy()
    dy = _bf16(torch.from_numpy(dy)).numpy()
    state = state if with_state else None

    def loss(*a):
        y, outs = jref.mlstm_chunk_jnp(*a, chunk=64)
        total = jnp.sum(y * dy)
        if state is not None:
            total = total + sum(jnp.sum(o * s) for o, s in zip(outs, state))
        return total
    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    return args, dy, state, want


def _mlstm_tc_bars(case, seed, with_state, once=()):
    args, dy, state, want = _mlstm_tc_case(case, seed, with_state)
    st = [None] * 3 if state is None else [torch.from_numpy(s)
                                           for s in state]
    got = _mlstm_tc_model(*map(torch.from_numpy, args), torch.from_numpy(dy),
                          *st, once=once)
    return _card_bars(got, want, (True, True, True, False, False))


# xlstm-350m's head width D = 512 at 2 heads over 256 steps, and a ragged
# D = 128 with the exp(-m) branch live
MLSTM_TC_CASES = [(1, 256, 2, 512, 0.0), (1, 130, 2, 128, -3.0)]


@pytest.mark.parametrize("with_state", [True, False], ids=["state", "y"])
@pytest.mark.parametrize("case", MLSTM_TC_CASES, ids=str)
def test_mlstm_tensor_core_model_meets_the_card_bars(case, with_state,
                                                     one_thread):
    assert all(_mlstm_tc_bars(case, 0, with_state)), MLSTM_NAMES


@pytest.mark.parametrize("once", MLSTM_SPLITS)
def test_one_rounding_of_an_mlstm_backward_operand_misses_the_bars(
        once, one_thread):
    """Why each float32 operand of the mLSTM backward takes two products
    (or is carried as a pair): rounded to bf16 once, each misses the
    float32 di's or df's bar or the bf16 dq's, dk's or dv's rows."""
    case = MLSTM_TC_CASES[0]
    assert all(_mlstm_tc_bars(case, 0, True))
    assert not all(_mlstm_tc_bars(case, 0, True, once=(once,)))
