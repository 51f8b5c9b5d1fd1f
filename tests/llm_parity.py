"""Shared parity checks for the port's LLM serving paths on the CPU against
the JAX reference (tests/test_torch_{dense,kv_int8,moe,vlm,encdec}.py).

A `Pair` is one reduced arch (`reduced(layers=2, d_model=128, vocab=256)`
as tests/test_models.py sizes it, one group for patterns longer than two)
in both packages on the same parameters: the reference's `init`, with
seeded numpy noise added to every leaf so that no leaf sits at its
constant init (norms, biases, gate_attn), carried over by
`repro_torch.convert`. Prompts, vision embeddings and audio frames are
drawn with numpy from a seed. Tolerance atol 1e-4 in float32; greedy
tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serving.engine import ServingEngine as RefServingEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine

ATOL = 1e-4
NOISE = 0.05


def reduced(get, arch, **replace):
    cfg = get(arch)
    layers = 2 if len(cfg.group_pattern) <= 2 else None
    cfg = cfg.reduced(layers=layers, d_model=128, vocab=256)
    return dataclasses.replace(cfg, **replace) if replace else cfg


class Pair:
    """`arch` reduced, with `replace` applied to both packages' configs;
    prompts of (batch, prompt) tokens and `steps` follow-up tokens."""

    def __init__(self, arch, *, batch=2, prompt=24, steps=4, seed=0,
                 **replace):
        self.cfg = reduced(get_config, arch, **replace)
        self.ref = ref_build_model(reduced(ref_get_config, arch, **replace))
        tree = jax.tree_util.tree_map(
            np.asarray, self.ref.init(jax.random.PRNGKey(seed)))
        rng = np.random.default_rng(seed + 1)
        tree = jax.tree_util.tree_map(
            lambda a: (a + NOISE * rng.standard_normal(a.shape))
            .astype(a.dtype), tree)
        self.tree = tree
        self.ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
        self.model = build_model(self.cfg)
        to_port = (convert.encdec_params_from_numpy if self.cfg.is_encdec
                   else convert.decoder_params_from_numpy)
        self.params = to_port(tree, self.cfg)
        self.batch, self.prompt, self.steps = batch, prompt, steps
        rng = np.random.default_rng(seed + 2)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (batch, prompt))
        self.follow = rng.integers(0, self.cfg.vocab_size, (batch, steps))
        self.extra = {}
        if self.cfg.family == "vlm":
            self.extra["vision_embeds"] = rng.standard_normal(
                (batch, self.cfg.cross_attn_states, self.cfg.vision_dim),
                dtype=np.float32)
        if self.cfg.is_encdec:
            self.extra["frames"] = rng.standard_normal(
                (batch, self.cfg.encoder_frames, self.cfg.d_model),
                dtype=np.float32)

    # ------------------------------------------------------------ batches
    def ref_batch(self, tokens=None):
        tokens = self.tokens if tokens is None else tokens
        out = {"tokens": jnp.asarray(tokens, jnp.int32)}
        out.update({k: jnp.asarray(v) for k, v in self.extra.items()})
        return out

    def port_batch(self, tokens=None):
        tokens = self.tokens if tokens is None else tokens
        out = {"tokens": torch.as_tensor(np.asarray(tokens))}
        out.update({k: torch.as_tensor(v) for k, v in self.extra.items()})
        return out

    # ------------------------------------------------------------ prefill
    def ref_prefill(self):
        return self.ref.prefill(self.ref_params, self.ref_batch(),
                                max_len=self.prompt + self.steps)

    def port_prefill(self):
        with torch.inference_mode():
            return self.model.prefill(self.params, self.port_batch(),
                                      max_len=self.prompt + self.steps)


def cache_leaves(cache, ref_cache):
    """(name, port leaf, reference leaf) for every leaf of every group of
    the two prefill/decode caches; the reference's leaves are stacked on
    a leading group axis. Asserts both trees have the same keys."""
    ref_groups = jax.tree_util.tree_map(np.asarray, ref_cache["groups"])
    out = []

    def walk(port, ref, g, name):
        if isinstance(port, dict):
            assert sorted(port) == sorted(ref), name
            for k in port:
                walk(port[k], ref[k], g, f"{name}/{k}")
        else:
            out.append((name, port, ref[g]))

    for g, group in enumerate(cache["groups"]):
        walk(group, ref_groups, g, f"group {g}")
    return out


# an int8 cache value is round(x / scale) of a float K/V entry that the
# two packages agree on within ATOL: where x / scale sits on a rounding
# boundary, the two may round to neighbouring steps. At most one step,
# and at most one value in INT8_FLIP_SHARE of a leaf.
INT8_FLIP_SHARE = 1e-3


def assert_leaf_close(name, port, want):
    assert str(port.dtype).removeprefix("torch.") == str(want.dtype), name
    assert tuple(port.shape) == want.shape, name
    got = port.numpy().astype(np.float64)
    want = want.astype(np.float64)
    if port.dtype == torch.int8:
        diff = np.abs(got - want)
        assert diff.max() <= 1, (name, diff.max())
        assert np.count_nonzero(diff) <= INT8_FLIP_SHARE * diff.size, \
            (name, np.count_nonzero(diff))
        return
    np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)


def check_prefill(pair, expect_leaves):
    """Prefill logits and every cache leaf against the reference; returns
    the port's (logits, cache)."""
    ref_logits, ref_cache = pair.ref_prefill()
    logits, cache = pair.port_prefill()
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == tuple(ref_logits.shape)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=ATOL)
    assert cache["pos"] == int(ref_cache["pos"]) == pair.prompt
    leaves = cache_leaves(cache, ref_cache)
    for name, port, want in leaves:
        assert_leaf_close(name, port, want)
    assert len(leaves) == expect_leaves
    return logits, cache


def port_cache_from_ref(ref_cache):
    """The reference's cache as the port's: a list of per-group dicts of
    CPU tensors and a host int position."""
    groups = jax.tree_util.tree_map(np.asarray, ref_cache["groups"])
    n = len(jax.tree_util.tree_leaves(groups)[0])

    def pick(tree, g):
        if isinstance(tree, dict):
            return {k: pick(v, g) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree[g]))

    return {"pos": int(ref_cache["pos"]),
            "groups": [pick(groups, g) for g in range(n)]}


def check_decode_steps(pair, from_ref_cache=False):
    """Decode steps from the prefill cache, each step's logits against
    the reference's. With `from_ref_cache` the port decodes from a copy
    of the reference's prefill cache, so that both start from the same
    int8 values (see INT8_FLIP_SHARE)."""
    _, ref_cache = pair.ref_prefill()
    if from_ref_cache:
        cache = port_cache_from_ref(ref_cache)
    else:
        _, cache = pair.port_prefill()
    for t in range(pair.steps):
        tok = pair.follow[:, t]
        ref_logits, ref_cache = pair.ref.decode_step(
            pair.ref_params, jnp.asarray(tok, jnp.int32), ref_cache)
        with torch.inference_mode():
            logits, cache = pair.model.decode_step(
                pair.params, torch.as_tensor(tok), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=ATOL, err_msg=f"step {t}")
    assert cache["pos"] == pair.prompt + pair.steps
    return cache, ref_cache


def check_teacher_forcing(pair, prefix=None):
    """prefill + decode_step logits == the full-sequence forward's logits
    at the same positions (tests/test_models.py::
    test_decode_matches_teacher_forcing), on the port alone."""
    tokens = np.concatenate([pair.tokens, pair.follow], axis=1)
    prefix = prefix or pair.prompt
    model, params = pair.model, pair.params
    with torch.inference_mode():
        full, _ = model.forward(params, pair.port_batch(tokens))
        logits, cache = model.prefill(params, pair.port_batch(
            tokens[:, :prefix]), max_len=tokens.shape[1])
        np.testing.assert_allclose(logits.numpy(),
                                   full[:, prefix - 1].numpy(), atol=ATOL)
        for t in range(prefix, tokens.shape[1]):
            logits, cache = model.decode_step(
                params, torch.as_tensor(tokens[:, t]), cache)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       atol=ATOL, err_msg=f"position {t}")


def check_generate(pair):
    """Greedy tokens of the port's engine on the CPU == the reference
    engine's."""
    steps = pair.steps
    ref_out = RefServingEngine(pair.ref, pair.ref_params).generate(
        pair.ref_batch(), steps)
    engine = ServingEngine(pair.model, pair.params, device="cpu")
    out = engine.generate(pair.port_batch(), steps)
    assert out.tokens.shape == (pair.batch, pair.prompt + steps)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(ref_out.tokens))
    assert out.prefill_seconds > 0 and out.decode_seconds > 0
