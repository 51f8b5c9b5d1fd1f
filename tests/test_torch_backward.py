"""Gradients on the CPU against the JAX reference: the plain versions of
the port's two backward kernels (`lstm_sequence_backward_plain`,
`flash_attention_backward_plain`, written from the formulas, which the
card's kernels are held to in tests/test_torch_cuda.py and chip_smoke.py)
against `jax.grad` of the reference's oracles and against torch.autograd
of the port's plain forwards; and the gradient of every model family's
loss against `jax.value_and_grad` of the reference's.

Tolerances (float32): the LSTM's gradients 1e-5 absolute + 1e-5 relative
against JAX and torch.autograd (the same float32 products, summed in
another order over the steps); flash's 2e-5 absolute and relative (the
forward's 2e-5, tests/test_kernels.py); the loss of each family 1e-5 and
each gradient leaf within 1e-3 of its largest entry (float32 sums in
another order through two layers; measured up to 1.5e-4, xlstm's).

A query row with no live key: the Pallas kernel, the port's kernel and
`flash_attention_plain` give 0 there, where the reference's oracle
averages over all keys (ROADMAP queue 3); so JAX is compared on rows that
have a live key, and torch.autograd of the plain version on all rows.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_parity import Pair
from repro.kernels import ref as jref
from repro_torch.kernels.flash_attention import (
    flash_attention_backward, flash_attention_backward_plain,
    flash_attention_lse_plain, flash_attention_plain)
from repro_torch.kernels.lstm_cell import (
    lstm_sequence_backward, lstm_sequence_backward_plain,
    lstm_sequence_plain, lstm_sequence_train_plain)

LSTM_TOL = 1e-5
FLASH_TOL = 2e-5

# (T, B, I, H): the three ICU workloads at batch 32, and the kernel's
# widest hidden size
LSTM_SHAPES = [(48, 32, 76, 16), (48, 32, 17, 8), (48, 32, 76, 32),
               (9, 3, 20, 256), (1, 2, 5, 4)]


def _lstm_inputs(shape, seed):
    t, b, i, h = shape
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(i + h)
    xs = rng.standard_normal((t, b, i)).astype(np.float32)
    wx = (rng.standard_normal((i, 4, h)) * s).astype(np.float32)
    wh = (rng.standard_normal((h, 4, h)) * s).astype(np.float32)
    bias = (rng.standard_normal((4, h)) * 0.1).astype(np.float32)
    ups = [rng.standard_normal((b, h)).astype(np.float32),
           rng.standard_normal((b, h)).astype(np.float32),
           rng.standard_normal((t, b, h)).astype(np.float32)]
    return (xs, wx, wh, bias), ups


def _plain_grads(args, ups):
    xs, wx, wh, b = (torch.as_tensor(a) for a in args)
    _, _, hs, gates, cs = lstm_sequence_train_plain(xs, wx, wh, b)
    return lstm_sequence_backward(xs, wx, wh, hs, gates, cs,
                                  *(torch.as_tensor(u) for u in ups))


@pytest.mark.parametrize("shape", LSTM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_backward_plain_matches_jax_grad(shape):
    """The gradient of sum(h_T gh) + sum(c_T gc) + sum(hs ghs) through
    the reference's `lstm_cell_reference` scanned over T from zeros."""
    args, ups = _lstm_inputs(shape, sum(shape))
    t, b, i, h = shape

    def loss(xs, wx, wh, bias):
        def step(carry, xt):
            hh, cc = jref.lstm_cell_reference(
                xt, *carry, wx.reshape(i, 4 * h), wh.reshape(h, 4 * h),
                bias.reshape(4 * h))
            return (hh, cc), hh
        zero = jnp.zeros((b, h), jnp.float32)
        (h_t, c_t), hs = jax.lax.scan(step, (zero, zero), xs)
        return (jnp.sum(h_t * ups[0]) + jnp.sum(c_t * ups[1])
                + jnp.sum(hs * ups[2]))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    for name, got, w in zip(("dxs", "dwx", "dwh", "db"),
                            _plain_grads(args, ups), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=LSTM_TOL, rtol=LSTM_TOL,
                                   err_msg=name)


def _fused_order_model(xs, wx, wh, hs, gates, cs, dh, dc, dhs):
    """The card's `lstm_sequence_backward` (csrc/lstm_cell.cu,
    `lstm_bwd_fused_kernel` and `lstm_bwd_reduce_kernel`) in plain torch,
    float32, in the kernels' order of arithmetic (a multiply-add where the
    kernel fuses one): the chain's factors as the kernel forms them; dh_next
    for H <= 32 as four sums per gate, one per residue of the unit mod 4,
    each over the units in order, then the residues and the gates summed
    pairwise, and for H > 32 as 32 lanes' sums (gate, then units l, l + 32,
    ...) summed by a butterfly; each batch row's partial [dwx; dwh; db]
    accumulated over t = T-1 ... 0; the rows summed over b = 0 ... B-1;
    dxs summed over the gate columns in order."""
    t_len, bsz, i_dim = xs.shape
    h_dim = wh.shape[0]
    g_dim = 4 * h_dim
    whf = wh.reshape(h_dim, 4, h_dim)               # [j, g, m]
    zero = torch.zeros(bsz, h_dim)
    dhn = zero if dh is None else dh.clone()
    dcar = zero if dc is None else dc.clone()
    # per row: u_t = [x_t, h_{t-1}, 1] (K = I + H + 1) against dG_t (4H)
    part = torch.zeros(bsz, i_dim + h_dim + 1, g_dim)
    dgs = torch.empty(t_len, bsz, g_dim)
    for t in range(t_len - 1, -1, -1):
        ig, fg, gg, og = torch.chunk(gates[t], 4, dim=-1)
        tc = torch.tanh(cs[t])
        cp = cs[t - 1] if t > 0 else zero
        up = zero if dhs is None else dhs[t]
        d_h = dhn + up
        dcar = dcar + d_h * (og * (1.0 - tc * tc))
        dg = torch.cat([dcar * (gg * ig * (1.0 - ig)),
                        dcar * (cp * fg * (1.0 - fg)),
                        dcar * (ig * (1.0 - gg * gg)),
                        d_h * (tc * og * (1.0 - og))], dim=-1)
        dcar = dcar * fg
        dgs[t] = dg
        terms = dg.reshape(bsz, 1, 4, h_dim) * whf[None]  # [b, j, g, m]
        if h_dim <= 32:
            acc = torch.zeros(bsz, h_dim, 4, 4)
            for m in range(h_dim):
                acc[..., m % 4] = acc[..., m % 4] + terms[..., m]
            gsum = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
            dhn = (gsum[..., 0] + gsum[..., 1]) + (gsum[..., 2] + gsum[..., 3])
        else:
            lanes = torch.zeros(bsz, h_dim, 32)
            for g in range(4):
                for m0 in range(0, h_dim, 32):
                    n = min(32, h_dim - m0)
                    lanes[..., :n] = lanes[..., :n] + terms[:, :, g, m0:m0 + n]
            for half in (16, 8, 4, 2, 1):
                lanes = lanes[..., :half] + lanes[..., half:2 * half]
            dhn = lanes[..., 0]
        h_prev = hs[t - 1] if t > 0 else zero
        u = torch.cat([xs[t], h_prev, torch.ones(bsz, 1)], dim=-1)
        part = part + u[:, :, None] * dg[:, None, :]
    total = torch.zeros_like(part[0])
    for b in range(bsz):
        total = total + part[b]
    wxf = wx.reshape(i_dim, g_dim)
    dxs = torch.zeros(t_len, bsz, i_dim)
    for n in range(g_dim):
        dxs = dxs + dgs[..., n, None] * wxf[:, n]
    return (dxs, total[:i_dim].reshape(i_dim, 4, h_dim),
            total[i_dim:i_dim + h_dim].reshape(h_dim, 4, h_dim),
            total[-1].reshape(4, h_dim))


@pytest.mark.parametrize("upstream", ["h", "all"])
@pytest.mark.parametrize("t_len", [1, 48])
@pytest.mark.parametrize("shape", [(32, 76, 16), (32, 17, 8), (32, 76, 32),
                                   (32, 130, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_backward_fused_order_matches_jax_grad(shape, t_len, upstream):
    """`_fused_order_model` against jax.grad of the reference's
    `lstm_cell_reference` scanned from zeros (upstream on h_T alone, or on
    h_T, c_T and hs) and against lstm_sequence_backward_plain, both at
    LSTM_TOL: the kernels' order of summation keeps the plain version's
    accuracy. At H = 256 the absolute part of the bar is LSTM_TOL times
    each gradient's largest entry (at least 1): there dwx and db sum
    1,536 products into entries up to ~50, and the plain version itself
    misses the unscaled bar against JAX (7 of dwx's 133,120 entries at
    T = 48, up to 3.1e-5 apart); model and plain differ by up to 2.6e-5."""
    b, i, h = shape
    args, ups = _lstm_inputs((t_len, b, i, h), sum(shape) + t_len)
    if upstream == "h":
        ups = [ups[0], np.zeros_like(ups[1]), np.zeros_like(ups[2])]

    def loss(xs, wx, wh, bias):
        def step(carry, xt):
            hh, cc = jref.lstm_cell_reference(
                xt, *carry, wx.reshape(i, 4 * h), wh.reshape(h, 4 * h),
                bias.reshape(4 * h))
            return (hh, cc), hh
        zero = jnp.zeros((b, h), jnp.float32)
        (h_t, c_t), hs = jax.lax.scan(step, (zero, zero), xs)
        return (jnp.sum(h_t * ups[0]) + jnp.sum(c_t * ups[1])
                + jnp.sum(hs * ups[2]))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    xs, wx, wh, bias = (torch.as_tensor(a) for a in args)
    _, _, hs, gates, cs = lstm_sequence_train_plain(xs, wx, wh, bias)
    up_t = [torch.as_tensor(u) for u in ups]
    if upstream == "h":
        up_t = [up_t[0], None, None]
    got = _fused_order_model(xs, wx, wh, hs, gates, cs, *up_t)
    plain = lstm_sequence_backward_plain(xs, wx, wh, hs, gates, cs, *up_t)
    for name, g, w, p in zip(("dxs", "dwx", "dwh", "db"), got, want, plain):
        w = np.asarray(w)
        atol = LSTM_TOL * (max(1.0, float(np.abs(w).max())) if h > 32
                           else 1.0)
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=LSTM_TOL,
                                   err_msg=name)
        torch.testing.assert_close(g, p, atol=atol, rtol=LSTM_TOL, msg=name)


@pytest.mark.parametrize("which", ["h", "c", "hs", "all"])
def test_lstm_backward_plain_matches_autograd(which):
    """Each upstream gradient alone (the others None, a zero gradient),
    and all three, against torch.autograd of the plain scan."""
    shape = (12, 4, 7, 8)
    args, ups = _lstm_inputs(shape, 5)
    pick = {"h": (0,), "c": (1,), "hs": (2,), "all": (0, 1, 2)}[which]
    ups_t = [torch.as_tensor(u) if k in pick else None
             for k, u in enumerate(ups)]
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    outs = lstm_sequence_plain(*leaves, return_sequence=True)
    loss = sum((o * u).sum() for o, u in zip(outs, ups_t) if u is not None)
    want = torch.autograd.grad(loss, leaves)
    xs, wx, wh, b = (t.detach() for t in leaves)
    _, _, hs, gates, cs = lstm_sequence_train_plain(xs, wx, wh, b)
    got = lstm_sequence_backward_plain(xs, wx, wh, hs, gates, cs, *ups_t)
    for name, g, w in zip(("dxs", "dwx", "dwh", "db"), got, want):
        torch.testing.assert_close(g, w, atol=LSTM_TOL, rtol=LSTM_TOL,
                                   msg=name)


def test_lstm_train_plain_matches_forward_and_bf16_record():
    """The training forward's h, c and hs are the plain scan's, in f32 and
    bf16; its cs is the state before the rounding to bf16, whose rounding
    is the carried c."""
    args, _ = _lstm_inputs((10, 3, 6, 8), 2)
    for dtype in (torch.float32, torch.bfloat16):
        ts = [torch.as_tensor(a).to(dtype) for a in args]
        h, c, hs, gates, cs = lstm_sequence_train_plain(*ts)
        hp, cp, hsp = lstm_sequence_plain(*ts, return_sequence=True)
        assert torch.equal(h, hp) and torch.equal(c, cp) and \
            torch.equal(hs, hsp)
        assert gates.dtype == cs.dtype == torch.float32
        assert gates.shape == (10, 3, 32) and cs.shape == (10, 3, 8)
        assert torch.equal(cs[-1].to(dtype), c)


# (b, hq, hkv, lq, lk, d, causal, window, softcap): GQA, windows, softcap,
# Lq < Lk, Lq > Lk without a causal mask (every row has a live key)
FLASH_CASES = [(1, 4, 2, 16, 16, 8, True, None, None),
               (2, 6, 1, 24, 24, 16, True, None, None),
               (1, 4, 2, 20, 20, 8, True, 5, 30.0),
               (1, 2, 2, 12, 30, 8, True, 7, None),
               (1, 2, 1, 30, 12, 8, False, None, 50.0),
               (2, 2, 2, 17, 17, 8, False, None, None)]
# rows with no live key: Lq > Lk causal (the first Lq - Lk rows), and a
# window of 0 (every row)
DEAD_ROW_CASES = [(1, 2, 1, 20, 8, 8, True, None, None),
                  (1, 2, 2, 8, 8, 8, True, 0, None),
                  (1, 4, 2, 24, 10, 8, True, 3, 20.0)]


def _flash_inputs(case, seed):
    b, hq, hkv, lq, lk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d),
                      (b, hq, lq, d))]


def _flash_plain_grads(case, arrays):
    q, k, v, dout = (torch.as_tensor(a) for a in arrays)
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    out, lse = flash_attention_lse_plain(q, k, v, **kw)
    return flash_attention_backward(q, k, v, out, lse, dout, **kw)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_plain_matches_jax_grad(case):
    arrays = _flash_inputs(case, sum(case[:6]))
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    dout = jnp.asarray(arrays[3])

    def loss(q, k, v):
        return jnp.sum(jref.attention_reference(q, k, v, **kw) * dout)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays[:3]))
    for name, got, w in zip("qkv", _flash_plain_grads(case, arrays), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=FLASH_TOL, rtol=FLASH_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", FLASH_CASES + DEAD_ROW_CASES, ids=str)
def test_flash_backward_plain_matches_autograd(case):
    """Against torch.autograd of flash_attention_plain, rows with no live
    key included: their output is 0, so their dq is 0 and they add
    nothing to dk and dv."""
    arrays = _flash_inputs(case, sum(case[:6]) + 1)
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    leaves = [torch.as_tensor(a).requires_grad_() for a in arrays[:3]]
    out = flash_attention_plain(*leaves, **kw)
    want = torch.autograd.grad((out * torch.as_tensor(arrays[3])).sum(),
                               leaves)
    got = _flash_plain_grads(case, arrays)
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, atol=FLASH_TOL, rtol=FLASH_TOL,
                                   msg=f"d{name}")
    _, lse = flash_attention_lse_plain(*(t.detach() for t in leaves), **kw)
    dead = torch.isinf(lse)
    if case in DEAD_ROW_CASES:
        assert bool(dead.any())
        assert bool((got[0][dead] == 0).all())


# ----------------------------------------------- the gradient of each family
# (arch, prompt): gemma2's 96 tokens exceed its reduced window of 64, so
# the sliding window bites; zamba2 and xlstm take the plain paths of their
# scans here (their backward kernels are held to the plain backwards in
# tests/test_torch_cuda.py)
FAMILIES = [("qwen2-1.5b", 32), ("gemma2-27b", 96), ("mixtral-8x7b", 32),
            ("llama-3.2-vision-11b", 32), ("seamless-m4t-large-v2", 32),
            ("zamba2-2.7b", 32), ("xlstm-350m", 32)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,prompt", FAMILIES,
                         ids=[a for a, _ in FAMILIES])
def test_loss_gradient_matches_jax_grad(arch, prompt):
    """`model.loss` and torch.autograd of it against jax.value_and_grad
    of the reference's loss, every parameter leaf, on noised weights
    (tests/llm_parity.py): dense, sliding/global with softcap, MoE (its
    aux term), VLM, encoder-decoder, and zamba2 and xlstm on the plain
    path."""
    pair = Pair(arch, batch=2, prompt=prompt)
    ref_loss, ref_grads = jax.value_and_grad(pair.ref.loss)(
        pair.ref_params, pair.ref_batch())
    leaves = list(_flat(pair.params))
    for _, t in leaves:
        t.requires_grad_(True)
    loss = pair.model.loss(pair.params, pair.port_batch())
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-5)
    want = dict(_flat(jax.tree.map(np.asarray, ref_grads)))
    assert sorted(want) == sorted(name for name, _ in leaves)
    for (name, _), g in zip(leaves, grads):
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)


# --------------------------------- xlstm's mLSTM gate biases against float64
# the reference's loss in float64: JAX with x64 on, in a process of its
# own, every `jnp.float32` the reference's model and kernel modules cast to
# read as float64 there, the config's dtype float64, the same weights and
# tokens (argv: an .npz of them in, an .npz of the gradients out)
X64_CODE = r"""
import dataclasses, importlib, pkgutil, sys
import numpy as np
import os

import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import repro


class F64:
    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


for info in pkgutil.walk_packages(repro.__path__, "repro."):
    if info.name.split(".")[1] in ("configs", "kernels", "models",
                                   "sharding", "training", "utils"):
        module = importlib.import_module(info.name)
        if getattr(module, "jnp", None) is jnp:
            module.jnp = F64()
from repro.configs import get_config
from repro.models import build_model

d = np.load(sys.argv[1])
cfg = get_config("xlstm-350m").reduced(d_model=128, vocab=256)
cfg = dataclasses.replace(cfg, dtype="float64", num_layers=16, num_groups=2)
params = {}
for name in d.files:
    if name != "tokens":
        *path, leaf = name.split("/")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(d[name], jnp.float64)
grads = jax.grad(build_model(cfg).loss)(
    params, {"tokens": jnp.asarray(d["tokens"], jnp.int32)})
flat = {}


def walk(tree, prefix):
    for key, value in tree.items():
        if isinstance(value, dict):
            walk(value, prefix + key + "/")
        else:
            flat[prefix + key] = np.asarray(value)


walk(grads, "")
np.savez(sys.argv[2], **flat)
"""


def test_mlstm_gate_bias_gradient_is_float32_rounding(tmp_path):
    """xlstm-350m at two groups of eight blocks, 2 x 16 tokens (the case
    where one mLSTM gate-bias entry sat 1.3e-3 of its leaf's largest entry
    from `jax.grad`, bar 1e-3): against the reference's loss in float64,
    the port's float32 gate-bias gradients are no further than the
    reference's own float32 ones, leaf by leaf's worst entry over the
    gate-bias leaves, scaled by each leaf's largest float64 entry. Both
    are ~1e-3 from float64 (the bias's gradient sums cancelling terms),
    so the 1.3e-3 is float32 rounding on both sides, not a port fault."""
    import subprocess
    import sys
    pair = Pair("xlstm-350m", batch=2, prompt=16, num_layers=16,
                num_groups=2)
    ref_grads = jax.grad(pair.ref.loss)(pair.ref_params, pair.ref_batch())
    leaves = list(_flat(pair.params))
    for _, t in leaves:
        t.requires_grad_(True)
    # one intra-op thread: beside parallel test workers, a pool of
    # threads is the bottleneck of a step's many small ops
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss = pair.model.loss(pair.params, pair.port_batch())
        got = dict(zip((n for n, _ in leaves), torch.autograd.grad(
            loss, [t for _, t in leaves])))
    finally:
        torch.set_num_threads(threads)
    want32 = dict(_flat(jax.tree.map(np.asarray, ref_grads)))
    weights = {name.strip("/"): a for name, a in _flat(pair.tree)}
    np.savez(tmp_path / "in.npz", tokens=pair.tokens, **weights)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run(
        [sys.executable, "-c", X64_CODE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu"),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want64 = np.load(tmp_path / "out.npz")
    gates = [n for n in want32 if n.endswith("gate_bias")]
    assert len(gates) >= 7

    def worst(a):
        return max(np.abs(a[n].astype(np.float64) - want64[n.strip("/")])
                   .max() / np.abs(want64[n.strip("/")]).max()
                   for n in gates)

    port = worst({n: got[n].numpy() for n in gates})
    ref = worst(want32)
    assert port <= ref, (port, ref)
    assert ref < 5e-3
