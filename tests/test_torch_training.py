"""The port's training slice against the JAX reference on the CPU: AdamW
(tests/test_training.py's cases), gradient accumulation, the 5-step loss
trajectory of the unsharded half of tests/test_distributed_parity.py, the
launcher, and the paper's offline phase (the three ICU classifiers
trained 60 steps, examples/serve_hierarchical.py). The gradient of every
family's loss is in tests/test_torch_backward.py.
Both packages start from the same weights (the reference's init, carried
over as numpy by `repro_torch.convert`) and see the same numpy batches.

Tolerances: the reference's own bars where it has them (AdamW's first
step 1e-5; microbatches 1e-5 on the loss, 1e-5 + 1e-4 relative on the
parameters; the trajectory 2e-4 relative on the losses and 5e-3 on the
parameters, test_distributed_parity.py's); the ICU trajectories 1e-5
relative per step (measured up to 6.9e-7), the final parameters 1e-5 and
the held-out accuracies equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.icu_lstm import ICU_WORKLOADS as REF_ICU_WORKLOADS
from repro.data import icu as ref_icu
from repro.data.pipeline import MarkovTokenDataset as RefMarkov
from repro.models import build_model as ref_build_model
from repro.models.lstm import ICULSTM as RefICULSTM
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_loop
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.pipeline import MarkovTokenDataset
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.training import optimizer, train_loop


# ------------------------------------------- tests/test_training.py's cases
def test_adamw_first_step_matches_manual():
    cfg = optimizer.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.0,
                                grad_clip=1e9)
    params = {"w": torch.ones((2, 2))}
    grads = {"w": torch.full((2, 2), 0.5)}
    state = optimizer.init(params)
    new, state2, _ = optimizer.update(cfg, grads, state, params)
    # bias-corrected mhat = g, vhat = g^2 -> delta = g/(|g|+eps) = 1
    lr0 = optimizer.schedule(cfg, 0)
    np.testing.assert_allclose(new["w"].numpy(), 1.0 - lr0, rtol=1e-5)
    assert state2.step == 1
    # the reference's step on the same inputs, and its schedule
    ref_cfg = ref_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.0,
                                  grad_clip=1e9)
    ref_new, _, _ = ref_opt.update(
        ref_cfg, {"w": jnp.full((2, 2), 0.5)},
        ref_opt.init({"w": jnp.ones((2, 2))}), {"w": jnp.ones((2, 2))})
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(ref_new["w"]),
                               rtol=1e-6)
    assert lr0 == float(ref_opt.schedule(ref_cfg,
                                         jnp.zeros((), jnp.int32)))


def test_grad_clip_bounds_update():
    cfg = optimizer.AdamWConfig(lr=1.0, warmup_steps=1, grad_clip=1.0,
                                weight_decay=0.0)
    params = {"w": torch.zeros((4,))}
    grads = {"w": torch.full((4,), 100.0)}
    _, _, stats = optimizer.update(cfg, grads, optimizer.init(params),
                                   params)
    assert float(stats["grad_norm"]) == 200.0


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 10_000,
                                  20_000])
def test_schedule_matches_reference(step):
    cfg = optimizer.AdamWConfig()
    want = float(ref_opt.schedule(ref_opt.AdamWConfig(),
                                  jnp.asarray(step, jnp.int32)))
    assert optimizer.schedule(cfg, step) == pytest.approx(want, rel=1e-6)


def test_update_matches_reference_with_decay_and_clip():
    """One AdamW step on a tree with a matrix (decayed), a vector (not
    decayed) and a bf16 leaf, gradients clipped, against the reference."""
    rng = np.random.default_rng(0)
    p_np = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"v": rng.standard_normal(5).astype(np.float32),
                  "h": rng.standard_normal((2, 3)).astype(np.float32)}}
    g_np = {"a": 3 * rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"v": rng.standard_normal(5).astype(np.float32),
                  "h": rng.standard_normal((2, 3)).astype(np.float32)}}
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=10, grad_clip=1.0)
    to_ref = lambda t: {"a": jnp.asarray(t["a"]),  # noqa: E731
                        "b": {"v": jnp.asarray(t["b"]["v"]),
                              "h": jnp.asarray(t["b"]["h"], jnp.bfloat16)}}
    to_port = lambda t: {"a": torch.tensor(t["a"]),  # noqa: E731
                         "b": {"v": torch.tensor(t["b"]["v"]),
                               "h": torch.tensor(t["b"]["h"])
                               .to(torch.bfloat16)}}
    rp, rs = to_ref(p_np), None
    rs = ref_opt.init(rp)
    pp = to_port(p_np)
    ps = optimizer.init(pp)
    for _ in range(3):
        rp, rs, rstats = ref_opt.update(ref_opt.AdamWConfig(**cfg),
                                        to_ref(g_np), rs, rp)
        pp, ps, pstats = optimizer.update(optimizer.AdamWConfig(**cfg),
                                          to_port(g_np), ps, pp)
    assert ps.step == int(rs.step) == 3
    np.testing.assert_allclose(float(pstats["grad_norm"]),
                               float(rstats["grad_norm"]), rtol=1e-6)
    for a, b in zip(optimizer.tree_leaves(convert.tree_to_numpy(pp)),
                    jax.tree.leaves(rp)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=1e-6,
                                   rtol=1e-5)
    for a, b in zip(optimizer.tree_leaves(convert.tree_to_numpy(ps.m)),
                    jax.tree.leaves(rs.m)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-7, rtol=1e-6)


def _clone(tree):
    return optimizer.tree_map(lambda t: t.detach().clone(), tree)


def test_microbatch_grads_equal_full_batch():
    """Grad accumulation must produce the same update as one big batch
    (the port's step updates in place, as the reference's donates, so each
    run starts from a copy)."""
    cfg = get_config("qwen2-1.5b").reduced(layers=2, d_model=64, vocab=64)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(1).integers(0, 64, (4, 16))
    batch = {"tokens": torch.as_tensor(tokens)}
    opt_cfg = optimizer.AdamWConfig(total_steps=10)
    out = {}
    for mb in (1, 2):
        step = train_loop.make_train_step(model, opt_cfg, microbatches=mb)
        p = _clone(params)
        out[mb] = step(p, optimizer.init(p), batch)
    (p1, _, m1), (p2, _, m2) = out[1], out[2]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(optimizer.tree_leaves(p1), optimizer.tree_leaves(p2)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   atol=1e-5, rtol=1e-4)


def test_microbatches_match_reference():
    """microbatches=2 in both packages from the same weights and tokens:
    loss and updated parameters."""
    rcfg = ref_get_config("qwen2-1.5b").reduced(layers=2, d_model=64,
                                                vocab=64)
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.PRNGKey(0))
    cfg = get_config("qwen2-1.5b").reduced(layers=2, d_model=64, vocab=64)
    model = build_model(cfg)
    params = convert.decoder_params_from_numpy(
        jax.tree.map(np.asarray, rparams), cfg)
    tokens = np.random.default_rng(1).integers(0, 64, (4, 16))
    rstep = ref_loop.make_train_step(ref, ref_opt.AdamWConfig(total_steps=10),
                                     microbatches=2)
    rp, _, rm = rstep(rparams, ref_opt.init(rparams),
                      {"tokens": jnp.asarray(tokens, jnp.int32)})
    step = train_loop.make_train_step(
        model, optimizer.AdamWConfig(total_steps=10), microbatches=2)
    p, _, m = step(params, optimizer.init(params),
                   {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    for a, b in zip(optimizer.tree_leaves(convert.tree_to_numpy(p)),
                    jax.tree.leaves(rp)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=1e-5,
                                   rtol=1e-4)


def test_eval_step_matches_reference_loss():
    """make_eval_step: the loss without gradients, the reference's eval
    step on the same weights and tokens."""
    rcfg = ref_get_config("gemma-2b").reduced(layers=2, d_model=64, vocab=64)
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.PRNGKey(2))
    cfg = get_config("gemma-2b").reduced(layers=2, d_model=64, vocab=64)
    params = convert.decoder_params_from_numpy(
        jax.tree.map(np.asarray, rparams), cfg)
    tokens = np.random.default_rng(3).integers(0, 64, (2, 16))
    want = ref_loop.make_eval_step(ref)(
        rparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = train_loop.make_eval_step(build_model(cfg))(
        params, {"tokens": torch.as_tensor(tokens)})
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_learns_markov_structure():
    cfg = get_config("gemma-2b").reduced(layers=2, d_model=128, vocab=128)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    ds = MarkovTokenDataset(vocab_size=128, seq_len=32, batch_size=8)
    params, _, hist = train_loop.train(model, params, ds.batches(),
                                       steps=50, log_every=50,
                                       log_fn=lambda *_: None)
    first, last = hist[0][1], hist[-1][1]
    assert last < first - 0.4, (first, last)
    assert last > ds.entropy_floor - 0.5   # can't beat the true entropy


# ------------------------ test_distributed_parity.py's unsharded trajectory
def test_five_step_trajectory_matches_reference():
    """qwen2 reduced to 2 layers, d_model 128, vocab 512; Markov 8 x 32;
    AdamW 5 steps, warm-up 1: the reference's jitted step against the
    port's, from the same weights on the same batches."""
    rcfg = ref_get_config("qwen2-1.5b").reduced(layers=2, d_model=128,
                                                vocab=512)
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    ref_batches = [b for b, _ in zip(
        RefMarkov(vocab_size=512, seq_len=32, batch_size=8).batches(),
        range(5))]
    rstep = ref_loop.make_train_step(
        ref, ref_opt.AdamWConfig(total_steps=5, warmup_steps=1), jit=True)
    rp, ro, ref_losses = rparams, ref_opt.init(rparams), []
    for b in ref_batches:
        rp, ro, m = rstep(rp, ro, b)
        ref_losses.append(float(m["loss"]))

    cfg = get_config("qwen2-1.5b").reduced(layers=2, d_model=128, vocab=512)
    model = build_model(cfg)
    p = convert.decoder_params_from_numpy(tree, cfg)
    o = optimizer.init(p)
    step = train_loop.make_train_step(
        model, optimizer.AdamWConfig(total_steps=5, warmup_steps=1))
    batches = [b for b, _ in zip(
        MarkovTokenDataset(vocab_size=512, seq_len=32,
                           batch_size=8).batches(), range(5))]
    losses = []
    for b, rb in zip(batches, ref_batches):
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(rb["tokens"]))
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4, atol=2e-4)
    d = max(float(np.abs(a - np.asarray(b, np.float32)).max())
            for a, b in zip(optimizer.tree_leaves(convert.tree_to_numpy(p)),
                            jax.tree.leaves(rp)))
    assert d < 5e-3, d
    assert o.step == 5


# ------------------------------------------------- the paper's offline phase
def test_icu_offline_phase_matches_reference():
    """examples/serve_hierarchical.py's train_offline: each ICU workload
    60 AdamW steps at batch 32 from the reference's init, the reference's
    `train_loop.train` against the port's `launch.train.train_offline`:
    every step's loss, the final parameters and the held-out accuracy."""
    state_dicts, ref = {}, {}
    for wl in REF_ICU_WORKLOADS:
        model = RefICULSTM(wl)
        params = model.init(jax.random.PRNGKey(0))
        state_dicts[wl.name] = convert.icu_lstm_params_from_numpy(
            jax.tree.map(np.asarray, params))
        x, y = ref_icu.generate(wl, 256, seed=0)

        def batches(x=x, y=y):
            rng = np.random.default_rng(0)
            while True:
                idx = rng.integers(0, 256, 32)
                yield {"features": jnp.asarray(x[idx]),
                       "labels": jnp.asarray(y[idx])}

        params, _, hist = ref_loop.train(model, params, batches(), steps=60,
                                         log_every=1, log_fn=lambda *_: None)
        xt, yt = ref_icu.generate(wl, 128, seed=9)
        logits = model.forward(params, jnp.asarray(xt))
        if wl.num_classes == 25:
            acc = float(jnp.mean((logits > 0) == jnp.asarray(yt)))
        else:
            acc = float(jnp.mean(jnp.argmax(logits, -1) == jnp.asarray(yt)))
        ref[wl.name] = ([loss for _, loss in hist], acc,
                        jax.tree.map(np.asarray, params))
    out = port_train.train_offline(60, device="cpu", state_dicts=state_dicts,
                                   log_fn=lambda *_: None)
    for name, (losses, acc, params) in ref.items():
        assert len(out[name]["losses"]) == 60
        np.testing.assert_allclose(out[name]["losses"], losses, rtol=1e-5)
        assert out[name]["accuracy"] == acc
        got = convert.icu_lstm_params_to_numpy(
            out[name]["model"].state_dict())
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_launcher_trains_reduced_arch_on_cpu():
    """`python -m repro_torch.launch.train --arch qwen2-1.5b --reduced`'s
    code path: losses finite, the schedule's learning rates, a
    checkpoint at the end that restores."""
    import tempfile

    from repro_torch.checkpoint import checkpointer
    with tempfile.TemporaryDirectory() as d:
        run = port_train.run("qwen2-1.5b", reduced=True, steps=4, batch=2,
                             seq=32, device="cpu", checkpoint_dir=d,
                             checkpoint_every=2, log_fn=lambda *_: None)
        assert len(run.losses) == 4 and np.isfinite(run.losses).all()
        cfg = port_train.opt_config(3e-4, 4)
        assert run.lrs == [optimizer.schedule(cfg, i) for i in range(4)]
        assert checkpointer.latest_step(d) == 4
        back = checkpointer.restore(d, {"params": run.params})
        for a, b in zip(optimizer.tree_leaves(back["params"]),
                        optimizer.tree_leaves(run.params)):
            assert torch.equal(a, b.detach())
        assert run.peak_bytes is None


def test_launcher_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps",
                         "1"])
