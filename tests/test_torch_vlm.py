"""The port's llama-3.2-vision-11b serving path (four ATTN blocks and one
gated CROSS block over projected vision embeddings) on the CPU against the
JAX reference, reduced (`reduced(d_model=128, vocab=256)`: one group, 16
vision states of width 64; tests/llm_parity.py). The 24-token prompts are
longer than the 16 cross states, so every prefill's cross attention has
Lq > Lk. Tolerance atol 1e-4; greedy tokens identical.
"""
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro_torch.configs import base
from repro_torch.data.pipeline import make_batch
from repro_torch.models import blocks
from repro_torch.serving.engine import ServingEngine

ARCH = "llama-3.2-vision-11b"


@pytest.fixture(scope="module")
def pair():
    return lp.Pair(ARCH, seed=12)


def test_prefill_logits_and_every_cache_leaf_match(pair):
    """k, v of the four self-attention blocks, and the cross block's
    static K/V of the projected vision states."""
    _, cache = lp.check_prefill(pair, expect_leaves=10)
    cross = cache["groups"][0]["b4_cross"]["attn"]
    assert tuple(cross["k"].shape) == (pair.batch, pair.cfg.num_kv_heads,
                                       pair.cfg.cross_attn_states,
                                       pair.cfg.head_dim)
    assert pair.prompt > pair.cfg.cross_attn_states


def test_decode_steps_match(pair):
    lp.check_decode_steps(pair)


def test_decode_matches_teacher_forcing(pair):
    lp.check_teacher_forcing(pair, prefix=pair.prompt - 3)


def test_generate_greedy_tokens_identical(pair):
    lp.check_generate(pair)


def test_cross_attention_reads_the_vision_states(pair):
    """The gated cross block is live: other vision embeddings give other
    logits in prefill and in decode (the static cross cache), and a zero
    gate_attn leaves the cross attention out."""
    def run(params, extra):
        batch = pair.port_batch()
        batch.update(extra)
        with torch.inference_mode():
            lg, cache = pair.model.prefill(params, batch,
                                           max_len=pair.prompt + 1)
            lg2, _ = pair.model.decode_step(
                params, torch.as_tensor(pair.follow[:, 0]), cache)
        return lg, lg2

    gate = pair.params["stack"]["groups"]["b4_cross"]["attn"]["gate_attn"]
    assert float(gate.abs().min()) > 0
    base = run(pair.params, {})
    other = run(pair.params, {"vision_embeds": torch.as_tensor(
        np.random.default_rng(0).standard_normal(
            pair.extra["vision_embeds"].shape, dtype=np.float32))})
    for a, b in zip(base, other):
        assert float((a - b).abs().max()) > 1e-3
    closed = {**pair.params}
    closed["stack"] = {"groups": {**pair.params["stack"]["groups"]}}
    cross = dict(closed["stack"]["groups"]["b4_cross"])
    cross["attn"] = {**cross["attn"],
                     "gate_attn": torch.zeros_like(gate)}
    closed["stack"]["groups"]["b4_cross"] = cross
    zeros = torch.zeros(pair.extra["vision_embeds"].shape)
    gated = [run(closed, {}), run(closed, {"vision_embeds": zeros})]
    for a, b in zip(*gated):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_engine_feeds_vision_embeds_in_the_model_dtype(monkeypatch):
    """A bfloat16 model gets float32 vision embeddings through the
    engine: they reach prefill in bfloat16, and decode passes no cross
    states."""
    cfg = lp.reduced(lp.get_config, ARCH, dtype="bfloat16")
    model = lp.build_model(cfg)
    seen = {}
    prefill = model.prefill

    def spy(params, batch, max_len=None):
        seen.update({k: v.dtype for k, v in batch.items()})
        return prefill(params, batch, max_len=max_len)

    monkeypatch.setattr(model, "prefill", spy)
    apply_cross = blocks._APPLY[base.CROSS]
    states = []

    def spy_cross(p, x, ctx, cache, mode):
        states.append((mode, ctx["cross_states"]))
        return apply_cross(p, x, ctx, cache, mode)

    monkeypatch.setitem(blocks._APPLY, base.CROSS, spy_cross)
    batch = make_batch(cfg, 2, 20, seed=1)
    batch["vision_embeds"] = batch["vision_embeds"].float()
    engine = ServingEngine(model, model.init(
        torch.Generator().manual_seed(0), device="cpu"), device="cpu")
    out = engine.generate(batch, 3)
    assert seen == {"tokens": torch.int64, "vision_embeds": torch.bfloat16}
    assert [m for m, _ in states] == ["prefill", "decode", "decode"]
    assert states[0][1].dtype == torch.bfloat16
    assert all(st is None for _, st in states[1:])
    assert out.tokens.shape == (2, 23)
