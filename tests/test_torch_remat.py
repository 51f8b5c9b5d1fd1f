"""Group rematerialisation (`build_model(cfg, remat=True)`) against the
reference's `jax.checkpoint` of its scan body, on the CPU.

Five reduced configs with two groups each (tests/llm_parity.py's sizes,
zamba2 and xlstm given a second group): dense (qwen2-1.5b), the hybrid
whose shared attention weights reach every group through ctx
(zamba2-2.7b), xlstm-350m, MoE with its row chunks checkpointed inside
the group's checkpoint (mixtral-8x7b at 16 x 16 tokens, 16 dispatch
groups in chunks of 8) and the encoder-decoder (seamless-m4t-large-v2,
the decoder's groups reading the encoder's output through ctx). Both
packages start from the same noised weights. For each config:

- the loss and every gradient with remat are bit-equal to those without
  (the recomputed forward is the forward: the same ops on the same CPU);
- autograd saves fewer bytes with remat (saved-tensor hooks outside the
  checkpoints, as tests/test_torch_recompute.py counts them);
- both agree with `jax.value_and_grad` of the reference built with
  `remat=True` at tests/test_torch_backward.py's bars (the loss 1e-5
  absolute, each gradient leaf 1e-3 of its largest entry);
- a training forward under grad enters one checkpoint per group, and
  none under `torch.no_grad()`.

Bit-equality is asked of deterministic algorithms: on the CPU the
embedding's backward (an accumulating `index_put_`) sums a repeated
token's rows in an order that varies between calls, with or without remat.
"""
import jax
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from llm_parity import Pair
from repro.models import build_model as ref_build_model
from repro_torch.models import build_model
from repro_torch.models import decoder

LOSS_ATOL, GRAD_REL = 1e-5, 1e-3

# arch -> (Pair's config changes, batch, prompt); prompts of 32 tokens as
# tests/test_torch_backward.py's FAMILIES
CASES = {
    "qwen2-1.5b": ({}, 2, 32),
    "zamba2-2.7b": (dict(num_layers=12, num_groups=2), 2, 32),
    "xlstm-350m": (dict(num_layers=16, num_groups=2), 2, 32),
    "mixtral-8x7b": ({}, 16, 16),
    "seamless-m4t-large-v2": ({}, 2, 32),
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(autouse=True)
def one_thread():
    """The reduced models run many small ops, which one intra-op thread
    runs faster than a pool sharing the CPU with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _groups(cfg):
    return cfg.num_groups + (cfg.encoder_layers if cfg.is_encdec else 0)


def _loss_and_grads(model, params, batch):
    """(loss, {leaf: gradient}, bytes autograd saved outside checkpoints,
    groups checkpointed in the forward) from fresh leaves."""
    leaves = [(n, t.clone().requires_grad_(True)) for n, t in _flat(params)]
    tree = {}
    for name, t in leaves:
        node = tree
        *path, last = name.strip("/").split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    saved, entered = [], []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    def counting(fn, *args, **kw):
        entered.append(getattr(fn, "__name__", ""))
        return checkpoint(fn, *args, **kw)

    checkpoint = torch.utils.checkpoint.checkpoint
    with pytest.MonkeyPatch.context() as m:
        m.setattr(decoder, "checkpoint", counting)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss(tree, batch)
        groups = entered.count("_group")
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return (loss.detach(), {n: g for (n, _), g in zip(leaves, grads)},
            sum(saved), groups)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_remat_matches_plain_and_reference(arch, deterministic):
    changes, batch, prompt = CASES[arch]
    pair = Pair(arch, batch=batch, prompt=prompt, **changes)
    assert _groups(pair.cfg) >= 2 * (1 + pair.cfg.is_encdec)
    plain = build_model(pair.cfg)
    remat = build_model(pair.cfg, remat=True)
    loss_p, grads_p, saved_p, groups_p = _loss_and_grads(
        plain, pair.params, pair.port_batch())
    loss_r, grads_r, saved_r, groups_r = _loss_and_grads(
        remat, pair.params, pair.port_batch())
    assert (groups_p, groups_r) == (0, _groups(pair.cfg))
    assert saved_r < saved_p, (saved_r, saved_p)
    assert torch.equal(loss_r, loss_p)
    assert sorted(grads_r) == sorted(grads_p)
    for name, g in grads_r.items():
        assert torch.equal(g, grads_p[name]), name

    ref = ref_build_model(pair.ref.cfg, remat=True)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(ref.loss))(
        pair.ref_params, pair.ref_batch())
    np.testing.assert_allclose(float(loss_r), float(ref_loss),
                               atol=LOSS_ATOL)
    want = dict(_flat(jax.tree.map(np.asarray, ref_grads)))
    assert sorted(want) == sorted(grads_r)
    for name, g in grads_r.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "seamless-m4t-large-v2"])
def test_remat_enters_no_checkpoint_without_grad(arch, monkeypatch):
    """Under no_grad (the eval step) and in inference mode (serving) a
    remat model runs its groups unwrapped, with the outputs of the model
    built without remat."""
    changes, batch, prompt = CASES[arch]
    pair = Pair(arch, batch=batch, prompt=prompt, steps=2, **changes)
    entered = []

    def counting(fn, *args, **kw):
        entered.append(fn)
        return fn(*args)
    monkeypatch.setattr(decoder, "checkpoint", counting)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    plain = build_model(pair.cfg)
    remat = build_model(pair.cfg, remat=True)
    with torch.no_grad():
        want = plain.loss(pair.params, pair.port_batch())
        got = remat.loss(pair.params, pair.port_batch())
    with torch.inference_mode():
        logits, _ = remat.prefill(pair.params, pair.port_batch())
        want_logits, _ = plain.prefill(pair.params, pair.port_batch())
    assert entered == []
    assert torch.equal(got, want)
    assert torch.equal(logits, want_logits)
