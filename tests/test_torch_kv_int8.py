"""The port's int8 KV cache on the CPU against the JAX reference:
`_quantize` bit for bit, qwen2-1.5b with `kv_cache_dtype="int8"` reduced
(`reduced(layers=2, d_model=128, vocab=256)`, float32 model, tests/
llm_parity.py) through prefill, decode and generate at atol 1e-4 with
identical greedy tokens (int8 cache values within one step, see
`llm_parity.assert_leaf_close`), int8 decode against the native cache within the
reference's 0.35 (tests/test_kv_int8.py), and the cache's bytes.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro.models.attention import _quantize as ref_quantize
from repro_torch.configs import get_config
from repro_torch.models import attention, build_model

ARCH = "qwen2-1.5b"


def _ties(shape):
    """Values whose quotient by the scale sits on .5: round half to even
    decides them (amax 127 * 0.5 gives scale 0.5)."""
    x = np.full(shape, 63.5, np.float32) * 0.5
    x[..., 0] = 63.5
    x[..., 1] = -0.75
    x[..., 2] = 1.25
    return x


QUANT_INPUTS = {
    "normal": lambda: np.random.default_rng(0).standard_normal(
        (2, 4, 16, 32), dtype=np.float32),
    "wide": lambda: (np.random.default_rng(1).standard_normal(
        (1, 2, 8, 128)) * 300).astype(np.float32),
    "zero-rows": lambda: np.where(np.arange(8)[None, None, :, None] % 3 == 0,
                                  0.0, np.random.default_rng(2)
                                  .standard_normal((2, 2, 8, 16)))
    .astype(np.float32),
    "ties": lambda: _ties((1, 1, 4, 8)),
}


@pytest.mark.parametrize("name", sorted(QUANT_INPUTS))
def test_quantize_bit_identical(name):
    x = QUANT_INPUTS[name]()
    q_ref, s_ref = ref_quantize(jnp.asarray(x))
    q, s = attention._quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    deq = q.float() * s[..., None]
    err = (deq - torch.from_numpy(x)).abs().amax(dim=-1)
    assert bool((err <= s / 2 * (1 + 1e-6)).all())   # half a step


def test_quantize_bf16_input_bit_identical():
    x = np.random.default_rng(3).standard_normal((2, 2, 8, 64),
                                                 dtype=np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q_ref, s_ref = ref_quantize(jnp.asarray(xb.float().numpy())
                                .astype(jnp.bfloat16))
    q, s = attention._quantize(xb)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


@pytest.fixture(scope="module")
def pair():
    return lp.Pair(ARCH, seed=5, kv_cache_dtype="int8")


def test_prefill_logits_and_every_cache_leaf_match(pair):
    """The int8 values and their scales of every slot (k, v, k_scale,
    v_scale per attention block)."""
    _, cache = lp.check_prefill(pair, expect_leaves=8)
    block = cache["groups"][0]["b0_attn"]["attn"]
    assert block["k"].dtype == block["v"].dtype == torch.int8
    assert block["k_scale"].shape == block["k"].shape[:3]


def test_decode_steps_match(pair):
    cache, ref_cache = lp.check_decode_steps(pair)
    for name, port, want in lp.cache_leaves(cache, ref_cache):
        lp.assert_leaf_close(name, port, want)


def test_generate_greedy_tokens_identical(pair):
    lp.check_generate(pair)


def test_int8_decode_close_to_native(pair):
    """tests/test_kv_int8.py::test_int8_decode_close_to_native on the
    port: the int8 cache's decode logits stay within 0.35 of the native
    cache's, with the same argmax."""
    native = dataclasses.replace(pair.cfg, kv_cache_dtype="native")
    tokens = np.concatenate([pair.tokens, pair.follow], axis=1)
    outs = {}
    for label, cfg in (("native", native), ("int8", pair.cfg)):
        model = build_model(cfg)
        with torch.inference_mode():
            _, cache = model.prefill(
                pair.params, {"tokens": torch.as_tensor(pair.tokens)},
                max_len=tokens.shape[1])
            outs[label] = []
            for t in range(pair.prompt, tokens.shape[1]):
                logits, cache = model.decode_step(
                    pair.params, torch.as_tensor(tokens[:, t]), cache)
                outs[label].append(logits)
    for a, b in zip(outs["native"], outs["int8"]):
        assert float((a - b).abs().max()) < 0.35
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_int8_halves_cache_bytes():
    """tests/test_kv_int8.py::test_int8_halves_cache_bytes on the port's
    init_cache (float32 reduced model: 4 bytes a value against 1 plus a
    scale per head_dim values)."""
    base = get_config(ARCH).reduced(layers=2, d_model=128, vocab=256)

    def cache_bytes(cfg):
        cache = build_model(cfg).init_cache(4, 4096, device="meta")
        return sum(t.numel() * t.element_size()
                   for g in cache["groups"] for b in g.values()
                   for t in b["attn"].values())

    native = cache_bytes(base)
    int8 = cache_bytes(dataclasses.replace(base, kv_cache_dtype="int8"))
    assert int8 < 0.35 * native


def test_int8_ring_buffer_decode_past_the_window():
    """gemma2's local layer with a window of 8 and the int8 cache: the
    ring's int8 slots and scales are overwritten in place as decode
    passes the window. The prefill caches agree within one int8 step; a
    one-step flip moves this model's decode logits by ~3e-4, so decode
    starts from the reference's prefill cache, and every step's logits
    and the caches at the end match the reference's."""
    pair = lp.Pair("gemma2-27b", batch=1, prompt=12, steps=10, seed=6,
                   attn_window=8, kv_cache_dtype="int8")
    lp.check_prefill(pair, expect_leaves=8)
    cache, ref_cache = lp.check_decode_steps(pair, from_ref_cache=True)
    for name, port, want in lp.cache_leaves(cache, ref_cache):
        lp.assert_leaf_close(name, port, want)
