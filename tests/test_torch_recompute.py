"""The CPU paths' recompute sites against the reference's: under grad, each
q block of `attention_blockwise` and each chunk of `mlstm_chunk_torch` is
a non-reentrant `torch.utils.checkpoint`, as the reference wraps the same
loop bodies in `jax.checkpoint` (src/repro/kernels/ref.py). Autograd then
saves fewer bytes, the outputs and every gradient are bit-equal to the
unwrapped loop, and the gradients agree with `jax.grad` of the
reference's function at the existing bars: attention 2e-5 absolute and
relative (tests/test_torch_backward.py's flash bar), the mLSTM 5e-4
absolute and 5e-3 relative (tests/test_torch_scan_backward.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.kernels import ref as jref
from repro_torch.kernels import ops

FLASH_TOL = 2e-5
MLSTM_ATOL, MLSTM_RTOL = 5e-4, 5e-3


def _grads(fn, arrays, ups):
    """sum(out * up) over fn's outputs under autograd: (outputs, the
    gradient of every input, the bytes autograd saved)."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        outs = fn(*leaves)
        loss = sum((o * torch.from_numpy(u)).sum() for o, u in zip(outs, ups))
    grads = torch.autograd.grad(loss, leaves)
    return [o.detach() for o in outs], grads, sum(saved)


def _unwrapped(monkeypatch, fn, arrays, ups):
    with monkeypatch.context() as m:
        m.setattr(torch.utils.checkpoint, "checkpoint",
                  lambda f, *args, use_reentrant: f(*args))
        return _grads(fn, arrays, ups)


def _check(monkeypatch, fn, arrays, ups, want, atol, rtol):
    outs, grads, saved = _grads(fn, arrays, ups)
    outs_u, grads_u, saved_u = _unwrapped(monkeypatch, fn, arrays, ups)
    assert saved < saved_u, (saved, saved_u)
    for o, ou in zip(outs, outs_u):
        assert torch.equal(o, ou)
    for g, gu, w in zip(grads, grads_u, want):
        assert torch.equal(g, gu)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=rtol)
    return saved, saved_u


@pytest.mark.parametrize("window", [None, 96])
def test_attention_blockwise_recomputes_each_q_block(monkeypatch, window):
    """Lq = 1024, where `ops.attention` takes the block-wise path on the
    CPU: two q blocks of 512, each recomputed in the backward."""
    rng = np.random.default_rng(31)
    q, k, v, dout = (rng.standard_normal((1, 2, 1024, 32), dtype=np.float32)
                     for _ in range(4))
    k, v = k[:, :1], v[:, :1]                       # GQA 2:1
    kw = dict(causal=True, window=window)

    def fn(*t):
        return [ops.attention(*t, **kw)]

    def loss(*t):
        return jnp.sum(jref.attention_blockwise(*t, **kw) * dout)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    saved, saved_u = _check(monkeypatch, fn, (q, k, v), (dout,), want,
                            FLASH_TOL, FLASH_TOL)
    # the unwrapped loop keeps each block's (512, 1024) float32
    # probabilities (and logits) per head
    assert saved_u - saved >= 2 * 2 * 512 * 1024 * 4


def test_mlstm_chunk_torch_recomputes_each_chunk(monkeypatch):
    """L = 512, where `ops.mlstm` takes the chunkwise path on the CPU at
    chunk 256, with cotangents on y and on the final (C, n, m)."""
    b, l, h, d = 1, 512, 2, 16
    rng = np.random.default_rng(32)
    q, k, v, dy = (rng.standard_normal((b, l, h, d), dtype=np.float32)
                   for _ in range(4))
    ig = rng.standard_normal((b, l, h), dtype=np.float32)
    fg = rng.standard_normal((b, l, h), dtype=np.float32) + 2.0
    ups = (dy, rng.standard_normal((b, h, d, d), dtype=np.float32),
           rng.standard_normal((b, h, d), dtype=np.float32),
           rng.standard_normal((b, h), dtype=np.float32))

    def fn(*t):
        y, state = ops.mlstm(*t)
        return [y, *state]

    def loss(*t):
        y, state = jref.mlstm_chunk_jnp(*t, chunk=256)
        return sum(jnp.sum(o * u) for o, u in zip((y, *state), ups))
    args = (q, k, v, ig, fg)
    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    saved, saved_u = _check(monkeypatch, fn, args, ups, want, MLSTM_ATOL,
                            MLSTM_RTOL)
    # the unwrapped loop keeps each chunk's (256, 256) weights per head
    assert saved_u - saved >= 2 * h * 256 * 256 * 4
