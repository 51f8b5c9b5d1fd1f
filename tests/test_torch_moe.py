"""The port's MoE block (mixtral) on the CPU against the JAX reference:
mixtral-8x7b and mixtral-8x22b reduced (`reduced(layers=2, d_model=128,
vocab=256)`: 4 experts, top-2, dropless capacity, sliding window;
tests/llm_parity.py) through prefill, decode, teacher forcing and
generate at atol 1e-4 with identical greedy tokens; `_moe_ffn` alone with
drops (capacity factor 1.0 and 0.5), EP-major expert storage and the
chunked dispatch; the load-balance aux; and the router's tie order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro.configs import get_config as ref_get_config
from repro.models import blocks as ref_blocks
from repro_torch.configs import get_config
from repro_torch.models import blocks

MOE = ("mixtral-8x7b", "mixtral-8x22b")


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    return lp.Pair(request.param, seed=7)


def test_prefill_logits_and_every_cache_leaf_match(pair):
    lp.check_prefill(pair, expect_leaves=4)


def test_decode_steps_match(pair):
    lp.check_decode_steps(pair)


def test_decode_matches_teacher_forcing(pair):
    lp.check_teacher_forcing(pair, prefix=pair.prompt - 3)


def test_generate_greedy_tokens_identical(pair):
    lp.check_generate(pair)


def test_ep_major_storage_serves_like_the_reference():
    """moe_ep_shards = 2: experts stored EP-major (E*r, d, f/r), rebuilt
    into (E, d, f) for the dispatch, as the reference does without a
    mesh."""
    pair = lp.Pair("mixtral-8x7b", seed=8, moe_ep_shards=2)
    experts = pair.params["stack"]["groups"]["b0_moe"]["experts"]
    assert sorted(experts) == ["ep_down", "ep_gate", "ep_up"]
    e, d, f = pair.cfg.num_experts, pair.cfg.d_model, pair.cfg.d_ff
    assert tuple(experts["ep_gate"].shape) == (2, 2 * e, d, f // 2)
    lp.check_prefill(pair, expect_leaves=4)
    lp.check_decode_steps(pair)
    lp.check_generate(pair)


def _moe_inputs(cfg, shape, seed):
    """One MoE block's parameters from the reference's init, noised, and
    an input x, as numpy."""
    p = jax.tree_util.tree_map(np.asarray, ref_blocks.init_block(
        "moe", jax.random.PRNGKey(seed), _ref_cfg(cfg)))
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        p)
    return p, rng.standard_normal(shape + (cfg.d_model,), dtype=np.float32)


def _ref_cfg(cfg):
    ref = ref_get_config(cfg.name.removesuffix("-smoke"))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    return dataclasses.replace(ref, **fields)


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _dropped(cfg, p, x):
    """Copies the capacity drops, over the dispatch groups of x."""
    import math
    h = torch.from_numpy(x)
    var = (h * h).mean(-1, keepdim=True)
    h = h * torch.rsqrt(var + cfg.norm_eps) * (1 + torch.from_numpy(
        p["moe_norm"]))
    probs = torch.softmax(h @ torch.from_numpy(p["router"]), -1)
    _, top_e = blocks._top_k(probs, cfg.num_experts_per_tok)
    bsz, s = x.shape[:2]
    g = s
    while g > blocks.MOE_GROUP and not s % (g // 2):
        g //= 2
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    cap = max(k, int(math.ceil(k * g / e * cfg.moe_capacity_factor)))
    counts = torch.nn.functional.one_hot(
        top_e.reshape(-1, g * k), e).sum(1)
    return int((counts - cap).clamp(min=0).sum())


# (capacity factor, EP shards, x's (B, S)): dropless, with drops, with
# heavy drops, EP-major, and 16 dispatch groups (the chunked path)
FFN_CASES = {"dropless": (4.0, 0, (2, 24)), "drops": (1.0, 0, (2, 48)),
             "heavy-drops": (0.5, 0, (2, 48)), "ep2": (1.0, 2, (2, 48)),
             "chunked": (1.0, 0, (16, 32))}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference(case):
    """`_moe_ffn` alone on the same parameters and input: the output and
    the load-balance aux; with capacity factor <= 1 copies are dropped."""
    factor, shards, shape = FFN_CASES[case]
    cfg = dataclasses.replace(
        lp.reduced(get_config, "mixtral-8x7b"), moe_capacity_factor=factor,
        moe_ep_shards=shards)
    p, x = _moe_inputs(cfg, shape, seed=11)
    want, want_aux = ref_blocks._moe_ffn(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        _ref_cfg(cfg))
    got, aux = blocks._moe_ffn(_port_tree(p), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=lp.ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    dropped = _dropped(cfg, p, x) if not shards else None
    if factor <= 1.0 and not shards:
        assert dropped > 0
    if factor > 1.0:
        assert dropped == 0


def test_moe_aux_matches_reference_and_is_at_least_one():
    """tests/test_models.py::test_moe_router_load_balance_aux_positive on
    both packages: the stack's summed moe_aux agrees, and is >= 1 (by
    Cauchy-Schwarz)."""
    pair = lp.Pair("mixtral-8x7b", seed=9)
    tokens = pair.tokens
    ref_x = pair.ref._embed(pair.ref_params, jnp.asarray(tokens, jnp.int32))
    _, _, ref_aux = pair.ref.stack.apply(
        pair.ref_params["stack"], ref_x,
        pair.ref._ctx(pair.ref_params, pair.ref_batch()), mode="train")
    with torch.inference_mode():
        x = pair.model._embed(pair.params, torch.as_tensor(tokens))
        _, _, aux = pair.model.stack.apply(
            pair.params["stack"], x,
            pair.model._ctx(pair.params, pair.port_batch()), mode="train")
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(ref_aux["moe_aux"]), rtol=1e-5)
    assert float(aux["moe_aux"]) >= 1.0 - 1e-3


def test_top_k_puts_the_lower_index_first_on_a_tie():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    want_w, want_e = jax.lax.top_k(jnp.asarray(probs), 2)
    w, e = blocks._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))


def test_ring_buffer_decode_past_the_window():
    """tests/test_models.py::test_sliding_window_decode_ring_buffer on the
    port: mixtral with a window of 8, decoding well past it."""
    pair = lp.Pair("mixtral-8x7b", batch=1, prompt=12, steps=12, seed=2,
                   attn_window=8)
    lp.check_prefill(pair, expect_leaves=4)
    lp.check_decode_steps(pair)
    lp.check_teacher_forcing(pair)


def _moe_grads(p, x, cfg, r):
    """loss = sum((x + y) r) + aux of `_moe_ffn` under autograd: (loss,
    the gradients of every parameter leaf the MoE FFN reads and of x, the
    bytes autograd saved for the backward)."""
    tree = _port_tree(p)
    leaves = [(n, tree[n]) for n in ("moe_norm", "router")]
    leaves += [(f"experts/{m}", t) for m, t in sorted(tree["experts"].items())]
    for _, t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, aux = blocks._moe_ffn(tree, xt, cfg)
        loss = (out * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [t for _, t in leaves] + [xt])
    return loss.detach(), dict(zip([n for n, _ in leaves] + ["x"], grads)), \
        sum(saved)


def test_chunked_moe_recomputes_each_chunk_under_grad(monkeypatch):
    """The chunked dispatch (16 dispatch groups, chunks of 8) under grad
    wraps each chunk in a non-reentrant checkpoint, as the reference wraps
    it in jax.checkpoint: autograd saves fewer bytes, the loss and every
    gradient are bit-equal to the unwrapped dispatch, and the gradients
    agree with jax.grad of the reference (tests/test_torch_backward.py's
    bar: 1e-3 of each leaf's largest entry)."""
    factor, shards, shape = FFN_CASES["chunked"]
    cfg = dataclasses.replace(
        lp.reduced(get_config, "mixtral-8x7b"), moe_capacity_factor=factor,
        moe_ep_shards=shards)
    assert shape[0] * shape[1] // min(shape[1], blocks.MOE_GROUP) \
        > blocks.MOE_CHUNK
    p, x = _moe_inputs(cfg, shape, seed=12)
    r = np.random.default_rng(13).standard_normal(
        x.shape, dtype=np.float32)
    loss, grads, saved = _moe_grads(p, x, cfg, r)

    with monkeypatch.context() as m:
        m.setattr(torch.utils.checkpoint, "checkpoint",
                  lambda fn, *args, use_reentrant: fn(*args))
        loss_u, grads_u, saved_u = _moe_grads(p, x, cfg, r)
    assert saved < saved_u
    assert torch.equal(loss, loss_u)
    assert sorted(grads) == sorted(grads_u)
    for name, g in grads.items():
        assert torch.equal(g, grads_u[name]), name

    def ref_loss(p_, x_):
        out, aux = ref_blocks._moe_ffn(p_, x_, _ref_cfg(cfg))
        return jnp.sum(out * jnp.asarray(r)) + aux
    ref_p = jax.tree_util.tree_map(jnp.asarray, p)
    want_loss, (gp, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        ref_p, jnp.asarray(x))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = {"x": np.asarray(gx)}
    want.update({n: np.asarray(gp[n]) for n in ("moe_norm", "router")})
    want.update({f"experts/{m}": np.asarray(w)
                 for m, w in gp["experts"].items()})
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
