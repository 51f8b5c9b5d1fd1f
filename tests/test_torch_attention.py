"""The port's attention on the CPU against the JAX reference: the plain
oracles (`attention_reference`, `attention_blockwise`), the flash kernel's
plain version, the op the models call, and the wrapper's checks. Inputs
are drawn with numpy from a seed and handed to both packages. The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py). Tolerance 2e-5 in float32, as
tests/test_kernels.py holds the Pallas kernel."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

# tests/test_kernels.py::ATTN_CASES
ATTN_CASES = [
    # b, hq, hkv, lq, lk, d, causal, window, softcap
    (2, 4, 2, 256, 256, 64, True, None, None),
    (1, 8, 1, 128, 128, 128, True, None, 50.0),     # MQA + softcap (gemma)
    (2, 4, 4, 256, 256, 64, True, 128, None),       # sliding window
    (1, 4, 2, 128, 512, 64, True, None, None),      # chunked prefill tail
    (1, 2, 2, 1, 256, 64, True, None, None),        # single-token decode
    (2, 2, 2, 128, 128, 32, False, None, None),     # bidirectional (encoder)
    (1, 4, 4, 256, 256, 64, True, 64, 30.0),        # window + softcap
]
ATOL = 2e-5
PORT_FNS = {"attention_reference": ref.attention_reference,
            "attention_blockwise": ref.attention_blockwise,
            "flash_attention_plain": flash_attention_plain}


def _qkv(b, hq, hkv, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, lq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, lk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, lk, d), dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _case(case):
    """Inputs of one case and the two JAX answers: the Pallas kernel in
    interpret mode and the jnp oracle."""
    b, hq, hkv, lq, lk, d, causal, window, softcap = case
    q, k, v = _qkv(b, hq, hkv, lq, lk, d, seed=sum(case[:6]))
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(pallas_flash(jq, jk, jv, interpret=True, **kw))
    oracle = np.asarray(jax_ref.attention_reference(jq, jk, jv, **kw))
    return (q, k, v), kw, pallas, oracle


@pytest.mark.parametrize("fn", sorted(PORT_FNS))
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_port_attention_matches_pallas_and_oracle(case, fn):
    (q, k, v), kw, pallas, oracle = _case(case)
    out = PORT_FNS[fn](*map(torch.from_numpy, (q, k, v)), **kw)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(out.numpy(), oracle, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("window", [None, 96])
def test_blockwise_long_matches_reference(window):
    """tests/test_kernels.py::test_attention_blockwise_matches_reference,
    port against JAX."""
    q, k, v = _qkv(2, 4, 2, 1024, 1024, 32, seed=7)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jax_ref.attention_blockwise(
        jq, jk, jv, causal=True, window=window, block_q=256))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = ref.attention_blockwise(tq, tk, tv, causal=True, window=window,
                                  block_q=256)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=ATOL)
    full = ref.attention_reference(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=ATOL,
                               rtol=ATOL)


def test_blockwise_lq_greater_than_lk_matches_reference():
    """Causal blockwise attention with more queries than keys (a negative
    query offset), over an even number of q blocks: port against JAX, and
    against the full reference on every row with a live key."""
    lq, lk = 2048, 1024
    q, k, v = _qkv(1, 2, 1, lq, lk, 32, seed=5)
    want = np.asarray(jax_ref.attention_blockwise(
        *map(jnp.asarray, (q, k, v)), causal=True, block_q=256))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = ref.attention_blockwise(tq, tk, tv, causal=True, block_q=256)
    assert out.shape == tq.shape
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=ATOL)
    full = ref.attention_reference(tq, tk, tv, causal=True)
    live = slice(lq - lk, None)
    np.testing.assert_allclose(out.numpy()[:, :, live],
                               full.numpy()[:, :, live], atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("plain", ["reference", "blockwise"])
def test_query_rows_from_an_offset_match_the_reference_rows(plain, window):
    """A slice of the query rows against every key, placed by `q_offset`
    (each "model" rank's rows where the heads do not divide it): the
    reference's full attention at those rows, for both plain paths and
    for `ops._attention_local`, which takes the blockwise path when the
    keys are long."""
    lq, rows = 2048, 512
    q, k, v = _qkv(1, 4, 2, lq, lq, 32, seed=9)
    want = np.asarray(jax_ref.attention_reference(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    fn = getattr(ref, f"attention_{plain}")
    for off in (0, 768, lq - rows):
        ql = tq[:, :, off:off + rows]
        out = fn(ql, tk, tv, causal=True, window=window, q_offset=off)
        np.testing.assert_allclose(out.numpy(), want[:, :, off:off + rows],
                                   atol=ATOL, rtol=ATOL)
    local = ops._attention_local(ql, tk, tv, True, window, None, None, 128,
                                 128, q_offset=off)
    np.testing.assert_allclose(local.numpy(), want[:, :, off:off + rows],
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("lq", [128, 1024])
def test_ops_attention_on_cpu_takes_the_reference_path(lq):
    """On CPU tensors `ops.attention` runs the plain path the reference's
    op takes off the TPU (blockwise from Lq = 1024) and launches no
    kernel."""
    q, k, v = _qkv(1, 2, 1, lq, lq, 32, seed=lq)
    want = np.asarray(jax_ops.attention(*map(jnp.asarray, (q, k, v)),
                                        causal=True))
    before = flash_attention.launches
    out = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert flash_attention.launches == before
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=ATOL)


def test_plain_gives_zero_for_rows_with_no_live_key():
    """A row with no live key: the Pallas kernel gives 0 and so does the
    plain version; the oracle averages over all keys (ROADMAP queue 3)."""
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=3)
    kw = dict(causal=True, window=0)
    want = np.asarray(pallas_flash(*map(jnp.asarray, (q, k, v)),
                                   interpret=True, **kw))
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), **kw)
    assert not np.any(want)
    np.testing.assert_array_equal(out.numpy(), want)
    oracle = ref.attention_reference(*map(torch.from_numpy, (q, k, v)), **kw)
    assert float(oracle.abs().max()) > 0


# Lq > Lk: more queries than keys, as cross attention gives when the text
# is longer than the cross states (the reduced llama-vision's 16). The
# Pallas kernel's query offset Lk - Lq is then negative.
LQ_GT_LK_CASES = [
    # b, hq, hkv, lq, lk, d, causal, window, softcap
    (2, 4, 2, 128, 16, 32, False, None, None),      # cross attention
    (1, 4, 4, 256, 128, 64, False, None, 50.0),     # + softcap
    (2, 4, 2, 256, 128, 32, True, None, None),      # causal: rows < 0 dead
    (1, 2, 1, 256, 128, 64, True, 64, None),        # causal + window
    (1, 2, 2, 256, 128, 32, False, 32, None),       # window alone
]


@pytest.mark.parametrize("case", LQ_GT_LK_CASES, ids=str)
def test_lq_greater_than_lk_matches_pallas(case):
    """The plain version (and the wrapper on CPU tensors) against the
    Pallas kernel in interpret mode: non-causal without a window every
    query sees every key; a causal row with no live key gives 0. Where
    every row has a live key the oracle agrees too."""
    (q, k, v), kw, pallas, oracle = _case(case)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for out in (flash_attention_plain(tq, tk, tv, **kw),
                flash_attention(tq, tk, tv, **kw)):
        assert out.shape == tq.shape
        np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL,
                                   rtol=ATOL)
    lq, lk = case[3], case[4]
    q_pos = np.arange(lq)[:, None] + lk - lq
    k_pos = np.arange(lk)[None, :]
    live = np.ones((lq, lk), bool)
    if case[6]:
        live &= k_pos <= q_pos
    if case[7] is not None:
        live &= k_pos > q_pos - case[7]
    dead = ~live.any(axis=1)
    assert dead.any() == case[6]
    assert not np.any(pallas[:, :, dead])
    np.testing.assert_allclose(pallas[:, :, ~dead], oracle[:, :, ~dead],
                               atol=ATOL, rtol=ATOL)


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(2, 4, 2, 40, 100, 80, seed=11))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=33)
    assert flash_attention.launches == before
    torch.testing.assert_close(
        out, flash_attention_plain(q, k, v, causal=True, window=33),
        atol=0, rtol=0)


def _args(**change):
    args = dict(zip("qkv", map(torch.from_numpy,
                               _qkv(1, 4, 2, 16, 32, 8, seed=0))))
    args.update(change)
    return args


@pytest.mark.parametrize("change,msg", [
    ({"q": torch.zeros(1, 3, 16, 8)}, r"GQA needs Hq % Hkv == 0, got \(3, 2\)"),
    ({"k": torch.zeros(1, 2, 32, 4)}, "must"),
    ({"v": torch.zeros(1, 2, 31, 8)}, "must"),
    ({"q": torch.zeros(4, 16, 8)}, "4 dims"),
    ({"q": torch.zeros(1, 4, 8, 16).transpose(2, 3)}, "contiguous"),
], ids=["gqa", "k-dim", "v-shape", "ndim", "contiguous"])
def test_wrapper_rejects_bad_inputs(change, msg):
    with pytest.raises(ValueError, match=msg):
        flash_attention(**_args(**change))


@pytest.mark.parametrize("change", [
    {"q": torch.zeros(1, 4, 16, 8, dtype=torch.float16)},
    {"k": torch.zeros(1, 2, 32, 8, dtype=torch.bfloat16)},
], ids=["float16", "mixed"])
def test_wrapper_rejects_bad_dtypes(change):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(**_args(**change))
