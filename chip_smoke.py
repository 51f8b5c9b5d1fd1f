#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel (lstm_cell, flash_attention, ssm_scan,
     mlstm_chunk), from the sources in this checkout, all nvcc processes
     at once;
  3. each kernel against its plain PyTorch version on the card, at its
     test shapes and at the shapes the main paths give it;
  4. the ICU LSTM models, and zamba2 and xlstm-350m at full width with one
     group, on the card (kernel path) against the same models on the CPU
     (plain path);
  5. the device tabu search on CUDA against the same search on the CPU;
  6. the main paths, each with every launch counter set to 0 just before
     it and read just after:
     a. `repro_torch.launch.serve.run(patients=100)`: calibrate, strategy
        table, lower bound, execution (lstm_cell);
     b. `ServingEngine(build_model(get_config("zamba2-2.7b"))).generate`
        at full width and depth in bf16: 4 prompts of 512 tokens, 32
        greedy steps (flash_attention, ssm_scan);
     c. the same for xlstm-350m (mlstm_chunk);
  7. timings with CUDA events, each printed beside the card's name and
     power limit;
  8. one more run of each main path under torch.profiler: device busy
     share and the kernels that take the device's time.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the checkout, the script exits non-zero and prints no
result.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 bytes/s, float32 (non-tensor-core) FLOP/s and
# bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# shapes of the correctness sweep: the kernel's test shapes, then the
# three ICU workloads (B, I, H) at B = 16 (calibrate) and B = 8 (execute)
TEST_SHAPES = [(4, 76, 16), (8, 17, 8), (128, 64, 128), (32, 130, 256)]
ICU_SHAPES = [(b, i, h) for (i, h) in ((76, 16), (17, 8), (76, 32))
              for b in (16, 8)]
KERNEL_ATOL = 1e-5
MODEL_ATOL = 1e-4
SERVE_PATIENTS = 100
CALIBRATE_RECORDS = 16      # serve.calibrate's unit_records
EXECUTE_RECORDS = 8         # records per executed job in serve.run

# flash_attention: tests/test_kernels.py::ATTN_CASES, zamba2's prefill
# shape, three ragged cases; (b, hq, hkv, lq, lk, d, causal, window,
# softcap). Tolerances of tests/test_kernels.py: 2e-5 f32, 2e-2 bf16.
ATTN_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, None),
    (1, 8, 1, 128, 128, 128, True, None, 50.0),
    (2, 4, 4, 256, 256, 64, True, 128, None),
    (1, 4, 2, 128, 512, 64, True, None, None),
    (1, 2, 2, 1, 256, 64, True, None, None),
    (2, 2, 2, 128, 128, 32, False, None, None),
    (1, 4, 4, 256, 256, 64, True, 64, 30.0)]
ZAMBA_ATTN = (4, 32, 32, 512, 512, 80, True, None, None)
RAGGED_ATTN = [(1, 4, 2, 1, 300, 64, True, None, None),
               (2, 4, 2, 100, 100, 80, True, 33, None),
               (1, 8, 1, 64, 64, 256, False, None, 50.0)]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# ssm_scan: tests/test_kernels.py::SSM_CASES, zamba2's prefill shape and
# two ragged shapes, (b, l, h, p, n). 3e-4 in f32 (tests/test_kernels.py); with x/b/c in
# bf16, y is rounded to bf16 on output (2e-2) while the final state is
# f32 on both sides from the same bf16 inputs (3e-4).
SSM_CASES = [(2, 64, 2, 8, 16), (2, 128, 4, 16, 16), (1, 256, 8, 32, 64)]
ZAMBA_SSM = (4, 512, 80, 64, 64)
RAGGED_SSM = [(2, 37, 3, 24, 20), (1, 70, 5, 80, 128)]
SSM_TOL = 3e-4
SSM_BF16_Y_TOL = 2e-2
# zamba2 (5 Mamba2 + 1 shared attention) and xlstm-350m (7 mLSTM + 1
# sLSTM) at full width with one group, float32, card vs CPU on the same
# parameters: float32 sums in another order over d_model = 2560 / 1024
ONE_GROUP_TOL = 2e-3
# the LLM serving paths: generate(make_batch(cfg, 4, 512), steps=32)
GEN_PROMPT = 512
GEN_BATCH = 4
GEN_STEPS = 32
# mlstm_chunk: tests/test_kernels.py::MLSTM_CASES, the reduced xlstm's
# D = 128, xlstm-350m's prefill shape, two ragged lengths (the last chunk
# of 64 cut short); (b, l, h, d). Tolerances of tests/test_kernels.py:
# y, C, n at 5e-4 absolute and 5e-3 relative, m at 1e-5; with q/k/v in
# bf16, y is rounded to bf16 on output (2e-2 + 2e-2 |y|) while the state
# is f32 on both sides from the same bf16 inputs (the f32 tolerances).
MLSTM_CASES = [(1, 64, 2, 64), (2, 128, 4, 32), (2, 256, 4, 16),
               (2, 256, 2, 128)]
XLSTM_MLSTM = (4, 512, 4, 512)
RAGGED_MLSTM = [(1, 100, 2, 128), (2, 300, 4, 512)]
MLSTM_ATOL, MLSTM_RTOL, MLSTM_M_ATOL = 5e-4, 5e-3, 1e-5
MLSTM_BF16_Y_TOL = 2e-2
MLSTM_CHUNK = 64                # the kernel's chunk length
XLSTM_BLOCKS = 7                # mLSTM blocks per group


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cell_inputs(torch, shape, device, seed):
    b, i, h = shape
    g = torch.Generator().manual_seed(seed)
    s = 1.0 / (i + h) ** 0.5
    args = [torch.randn(b, i, generator=g), torch.randn(b, h, generator=g),
            torch.randn(b, h, generator=g),
            torch.randn(i, 4, h, generator=g) * s,
            torch.randn(h, 4, h, generator=g) * s,
            torch.randn(4, h, generator=g) * 0.1]
    return [a.to(device) for a in args]


def cell_bound(shape):
    """Least time (ms) of one lstm_cell step on the card, as its two
    parts: each input read once and each output written once over the
    HBM rate, and 8·B·H·(I+H) matmul FLOPs plus ~25 pointwise operations
    per output unit over the float32 rate. The bound is the larger."""
    b, i, h = shape
    nbytes = 4 * (b * i + 2 * b * h + 4 * h * (i + h) + 4 * h + 2 * b * h)
    ops = 8 * b * h * (i + h) + 25 * b * h
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def flash_inputs(torch, case, dtype, device, seed):
    b, hq, hkv, lq, lk, d = case[:6]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device, dtype)
            for shape in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]


def flash_kwargs(case):
    return dict(causal=case[6], window=case[7], softcap=case[8])


def flash_bound(case, itemsize, flops_per_s):
    """Least time (ms) of one flash_attention call, as its two parts: q,
    k, v read once and o written once over the HBM rate, and the
    q.k and p.v products over the live (query, key) pairs of these masks
    (2 FLOPs per multiply-add, 2 products of D) over the peak rate for
    the inputs' type."""
    b, hq, hkv, lq, lk, d, causal, window, _ = case
    nbytes = itemsize * d * (2 * b * hq * lq + 2 * b * hkv * lk)
    live = 0
    for i in range(lq):
        qp = lk - lq + i
        hi = qp + 1 if causal else lk
        lo = max(0, qp - window + 1) if window is not None else 0
        live += max(0, min(hi, lk) - lo)
    ops = 4 * b * hq * live * d
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / flops_per_s * 1e3


def ssm_inputs(torch, shape, dtype, device, seed):
    b, l, h, p, n = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, l, h, p, generator=g).to(device, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=g)).to(device)
    a = -torch.exp(torch.randn(h, generator=g) * 0.5).to(device)
    bm = torch.randn(b, l, n, generator=g).to(device, dtype)
    cm = torch.randn(b, l, n, generator=g).to(device, dtype)
    d = torch.randn(h, generator=g).to(device)
    return [x, dt, a, bm, cm, d]


def ssm_bound(shape, itemsize, flops_per_s):
    """Least time (ms) of one ssm_scan call, as its two parts: x, b, c
    (itemsize bytes), dt, a, d (f32) read once and y (itemsize) and the
    f32 final state written once over the HBM rate; and the recurrence's
    arithmetic (per state element and step: decay·h + dx·B, then h·C:
    5 FLOPs; per output element dt·x, D·x and the sum: 3) over the peak
    rate for the inputs' type."""
    b, l, h, p, n = shape
    nbytes = (itemsize * (2 * b * l * h * p + 2 * b * l * n)
              + 4 * (b * l * h + 2 * h + b * h * p * n))
    ops = 5 * b * l * h * p * n + 3 * b * l * h * p
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / flops_per_s * 1e3


def mlstm_inputs(torch, shape, dtype, device, seed):
    """q, k, v normal in `dtype`; the gates normal in f32, the forget
    gate's shifted by +2, as the reference's tests draw them."""
    b, l, h, d = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, l, h, d, generator=g).to(device, dtype)
               for _ in range(3))
    ig = torch.randn(b, l, h, generator=g).to(device)
    fg = (torch.randn(b, l, h, generator=g) + 2.0).to(device)
    return [q, k, v, ig, fg]


def mlstm_bound(shape, itemsize, flops_per_s):
    """Least time (ms) of one mlstm_chunk call, as its two parts: q, k, v
    (itemsize bytes) and the f32 gates read once and y (itemsize) and the
    f32 final C, n, m written once over the HBM rate; and the chunkwise
    function's products over the peak rate for the inputs' type: per
    chunk of tn steps and (b, h), q.k^T and S.v over the live pairs
    u <= t (2 D tn (tn + 1)), k^T v into C (2 tn D^2), and from the second
    chunk on q.C_in and the carry (2 tn D^2 + D^2), plus n and q.n
    (4 tn D). The first chunk starts from C = 0, so it needs no q.C_in."""
    b, l, h, d = shape
    nbytes = (itemsize * 4 * b * l * h * d
              + 4 * (2 * b * l * h + b * h * (d * d + d + 1)))
    ops = 0
    for c, t0 in enumerate(range(0, l, MLSTM_CHUNK)):
        tn = min(MLSTM_CHUNK, l - t0)
        ops += 2 * d * tn * (tn + 1) + 2 * tn * d * d + 4 * tn * d
        if c:
            ops += 2 * tn * d * d + d * d
    ops *= b * h
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / flops_per_s * 1e3


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def one_group_card_vs_cpu(torch, model, p_gpu, prompt, kernels, label):
    """Prefill `prompt` and 4 greedy decode steps with `model` on the card
    from `p_gpu` and on the CPU from a copy; raises unless every step's
    logits agree within ONE_GROUP_TOL. Returns the largest error in
    prefill and in decode, and the launches of each of `kernels` in
    prefill and in decode."""
    cuda = torch.device("cuda")
    p_cpu = tree_to(p_gpu, "cpu")
    plen = prompt.shape[1]
    counts, errs = [], []

    def snap():
        counts.append(tuple(k.launches for k in kernels))

    def compare(lg, lc, what):
        err = float((lg.cpu() - lc).abs().max())
        errs.append(err)
        if lg.shape != lc.shape or not bool(torch.isfinite(lg).all()) or \
                not torch.allclose(lg.cpu(), lc, atol=ONE_GROUP_TOL,
                                   rtol=ONE_GROUP_TOL):
            raise RuntimeError(f"{label} {what}: card and CPU logits differ "
                               f"by {err}")

    with torch.inference_mode():
        snap()
        lg, cg = model.prefill(p_gpu, {"tokens": prompt.to(cuda)},
                               max_len=plen + 4)
        torch.cuda.synchronize()
        snap()
        lc, cc = model.prefill(p_cpu, {"tokens": prompt}, max_len=plen + 4)
        compare(lg, lc, "prefill")
        tok = lc.argmax(-1)
        for step in range(4):
            lg, cg = model.decode_step(p_gpu, tok.to(cuda), cg)
            lc, cc = model.decode_step(p_cpu, tok, cc)
            compare(lg, lc, f"decode step {step}")
            tok = lc.argmax(-1)
        torch.cuda.synchronize()
        snap()
    pre = tuple(b - a for a, b in zip(counts[0], counts[1]))
    dec = tuple(b - a for a, b in zip(counts[1], counts[2]))
    return errs[0], max(errs[1:]), pre, dec


def trace_generate(torch, engine, batch, label, card):
    """The serving path traced twice under torch.profiler: prefill alone
    (steps=1), then prefill and 7 decode steps; the difference, over 7,
    is what one decode step costs."""
    from torch.profiler import ProfilerActivity, profile
    traced = {}
    for steps in (1, 8):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = engine.generate(batch, steps=steps)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        traced[steps] = (traced_s,) + print_profile(
            prof, f"[{card}] traced {label} generate(4 x {GEN_PROMPT}, "
            f"steps={steps}) (prefill {res.prefill_seconds:.4f} s, decode "
            f"{res.decode_seconds:.4f} s)", traced_s, 12)
    per = [(b - a) / 7 for a, b in zip(traced[1], traced[8])]
    print(f"[{card}] traced {label} decode step: wall {per[0] * 1e3:.3f} "
          f"ms, device busy {per[1] * 1e3:.3f} ms ({per[1] / per[0]:.2%}), "
          f"{per[2]:.0f} device events")


def drive_generate(torch, cfg, kernels, per_prefill, card):
    """The serving path of `cfg` at full width and depth:
    `ServingEngine(build_model(cfg), device="cuda").generate(make_batch(
    cfg, 4, 512), steps=32)` with random weights drawn on the card, every
    counter of `kernels` (name -> wrapper) set to 0 just before and read
    just after. Raises unless the run launched `per_prefill` (one
    prefill), the tokens extend the prompt within the vocab, a second
    greedy run gives the same tokens, and one more prefill and decode step
    launch `per_prefill` and nothing and give finite logits of the padded
    vocab's shape with the padding masked. Returns (engine, batch, the
    launches of the first run)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model
    from repro_torch.models.decoder import padded_vocab
    from repro_torch.serving.engine import ServingEngine
    cuda = torch.device("cuda")

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    held = torch.cuda.memory_allocated()   # by earlier phases
    t0 = time.perf_counter()
    engine = ServingEngine(build_model(cfg), device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(engine.params))
    batch = make_batch(cfg, GEN_BATCH, GEN_PROMPT, seed=0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    gen = engine.generate(batch, steps=GEN_STEPS)
    launched = counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    toks = gen.tokens
    print(f"{cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.dtype}) "
          f"drawn on the card in {init_s:.2f} s; generate("
          f"{tuple(batch['tokens'].shape)}, steps={GEN_STEPS}) -> tokens "
          f"{tuple(toks.shape)}; launches {launched}")
    want_shape = (GEN_BATCH, GEN_PROMPT + GEN_STEPS)
    if tuple(toks.shape) != want_shape or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size or not torch.equal(
                toks[:, :GEN_PROMPT].cpu(), batch["tokens"]):
        raise RuntimeError(f"{cfg.name} generate: bad tokens "
                           f"{tuple(toks.shape)}")
    if launched != per_prefill:
        raise RuntimeError(f"{cfg.name} generate: launches {launched}, "
                           f"expected {per_prefill}")
    gen2 = engine.generate(batch, steps=GEN_STEPS)
    if not torch.equal(gen2.tokens, toks):
        raise RuntimeError(f"{cfg.name} generate: a second greedy run "
                           f"returned other tokens")
    with torch.inference_mode():
        c0 = counts()
        lg, cache = engine.model.prefill(
            engine.params, {"tokens": batch["tokens"].to(cuda)},
            max_len=GEN_PROMPT + 1)
        c1 = counts()
        lg2, _ = engine.model.decode_step(engine.params, lg.argmax(-1),
                                          cache)
        c2 = counts()
    pre = {name: c1[name] - c0[name] for name in kernels}
    dec = {name: c2[name] - c1[name] for name in kernels}
    print(f"{cfg.name}: launches per prefill {pre}, per decode step {dec}")
    if pre != per_prefill or any(dec.values()):
        raise RuntimeError(f"{cfg.name}: launches per prefill {pre}, per "
                           f"decode step {dec}")
    vpad = padded_vocab(cfg.vocab_size)
    for what, logits in (("prefill", lg), ("decode", lg2)):
        pad = logits[:, cfg.vocab_size:]
        if tuple(logits.shape) != (GEN_BATCH, vpad) or \
                not bool(torch.isfinite(logits).all()) or \
                (pad.numel() and float(pad.max()) > -1e29):
            raise RuntimeError(f"{cfg.name} {what} logits: shape "
                               f"{tuple(logits.shape)}, not finite or the "
                               f"vocab padding not masked")
    del cache
    for label, g in (("run 1", gen), ("run 2", gen2)):
        print(f"[{card}] {cfg.name} generate {label}: prefill "
              f"{g.prefill_seconds:.4f} s, decode "
              f"{g.decode_seconds / (GEN_STEPS - 1) * 1e3:.3f} ms per "
              f"step ({GEN_STEPS - 1} steps, {g.decode_seconds:.3f} s)")
    print(f"[{card}] {cfg.name} generate: peak device memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated less the "
          f"{held / 1e9:.2f} GB that earlier phases hold)")
    return engine, batch, launched


def event_ms(torch, fn, iters, warmup=20):
    """Mean ms per call of `fn` over `iters` calls, CUDA events around the
    whole run, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, per_graph=100, replays=20):
    """Mean ms per call of `fn` replayed from a CUDA graph: the device time
    without the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return event_ms(torch, graph.replay, replays, warmup=2) / per_graph


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def print_profile(prof, label, wall_s, top):
    """Device busy share (the device-side events' summed time over the
    traced run's wall time, which the tracing inflates) and the device
    events (kernels, copies, fills) that take the most of it. Host-side
    ops also report the device time of the kernels they launch; they are
    left out, so no device time is counted twice."""
    from torch.autograd import DeviceType
    dev_us = sorted(((e.self_device_time_total, e.key, e.count)
                     for e in prof.key_averages()
                     if e.device_type != DeviceType.CPU), reverse=True)
    busy_s = sum(d for d, _, _ in dev_us) / 1e6
    events = sum(n for _, _, n in dev_us)
    print(f"{label}: wall {wall_s:.3f} s, device busy {busy_s:.4f} s "
          f"({busy_s / wall_s:.2%}) in {events} device events; top device "
          f"self time:")
    for d, key, n in dev_us[:top]:
        print(f"  {key[:80]:80s} {d / 1e3:10.3f} ms  x{n}")
    return busy_s, events


def int_instance(sim, tiers, rng, n):
    """Tie-heavy integer jobs: float32 sums are exact in any order."""
    cc, es, ed = tiers.CC, tiers.ES, tiers.ED
    return [sim.JobSpec(name=f"J{i}", release=float(rng.integers(0, 30)),
                        weight=float(rng.integers(1, 4)),
                        proc={t: float(rng.integers(1, 30))
                              for t in (cc, es, ed)},
                        trans={cc: float(rng.integers(0, 60)),
                               es: float(rng.integers(0, 15)), ed: 0.0})
            for i in range(n)]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.icu_lstm import ICU_WORKLOADS
    from repro_torch.core import scheduler, scheduler_torch
    from repro_torch.core import simulator as sim
    from repro_torch.core import tiers
    from repro_torch.data import icu
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_plain
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_plain
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.lstm import ICULSTM
    from repro_torch.serving.engine import ClassifierEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 matmuls
    cuda = torch.device("cuda")

    # 1. environment
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    libs = build.build("lstm_cell", "flash_attention", "ssm_scan",
                       "mlstm_chunk")
    print(f"build: {len(libs)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s")

    # 3. kernel vs plain version
    max_err = 0.0
    for k, shape in enumerate(TEST_SHAPES + ICU_SHAPES):
        args = cell_inputs(torch, shape, cuda, seed=k)
        hk, ck = lstm_cell(*args)
        hp, cp = lstm_cell_plain(*args)
        torch.cuda.synchronize()
        err = max(float((hk - hp).abs().max()), float((ck - cp).abs().max()))
        print(f"lstm_cell {shape}: max |kernel - plain| = {err:.3e}")
        if not err <= KERNEL_ATOL:
            raise RuntimeError(f"lstm_cell {shape}: error {err} > "
                               f"{KERNEL_ATOL}")
        max_err = max(max_err, err)

    flash_err = {}
    for k, case in enumerate(ATTN_CASES + [ZAMBA_ATTN] + RAGGED_ATTN):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q, kk, v = flash_inputs(torch, case, dtype, cuda, seed=k)
            out = flash_attention(q, kk, v, **flash_kwargs(case))
            want = flash_attention_plain(q, kk, v, **flash_kwargs(case))
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            tol = ATTN_TOL[name]
            print(f"flash_attention {case} {name}: max |kernel - plain| = "
                  f"{err:.3e} (atol = rtol = {tol})")
            if out.dtype != dtype or not torch.allclose(
                    out.float(), want.float(), atol=tol, rtol=tol):
                raise RuntimeError(f"flash_attention {case} {name}: kernel "
                                   f"and plain version disagree")
            flash_err[(case, name)] = err

    ssm_err = {}
    for k, shape in enumerate(SSM_CASES + [ZAMBA_SSM] + RAGGED_SSM):
        dtypes = (torch.float32,) if shape in SSM_CASES \
            else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
            name = str(dtype).removeprefix("torch.")
            args = ssm_inputs(torch, shape, dtype, cuda, seed=k)
            y, hf = ssm_scan(*args)
            yp, hp = ssm_scan_plain(*args)
            torch.cuda.synchronize()
            y_tol = SSM_TOL if dtype == torch.float32 else SSM_BF16_Y_TOL
            y_err = float((y.float() - yp.float()).abs().max())
            h_err = float((hf - hp).abs().max())
            print(f"ssm_scan {shape} {name}: max |kernel - plain| y "
                  f"{y_err:.3e} (atol = rtol = {y_tol}), state {h_err:.3e} "
                  f"(atol = rtol = {SSM_TOL})")
            if y.dtype != dtype or not (
                    torch.allclose(y.float(), yp.float(), atol=y_tol,
                                   rtol=y_tol)
                    and torch.allclose(hf, hp, atol=SSM_TOL, rtol=SSM_TOL)):
                raise RuntimeError(f"ssm_scan {shape} {name}: kernel and "
                                   f"plain version disagree")
            ssm_err[(shape, name)] = max(y_err, h_err)

    mlstm_err = {}
    for k, shape in enumerate(MLSTM_CASES + [XLSTM_MLSTM] + RAGGED_MLSTM):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            args = mlstm_inputs(torch, shape, dtype, cuda, seed=300 + k)
            before = mlstm_chunk.launches
            y, state = mlstm_chunk(*args)
            launched = mlstm_chunk.launches - before
            yp, state_p = mlstm_chunk_plain(*args)
            torch.cuda.synchronize()
            y_tol = ((MLSTM_ATOL, MLSTM_RTOL) if dtype == torch.float32
                     else (MLSTM_BF16_Y_TOL, MLSTM_BF16_Y_TOL))
            pairs = {"y": (y.float(), yp.float(), y_tol)}
            for part, a, b in zip("Cnm", state, state_p):
                pairs[part] = (a, b, (MLSTM_M_ATOL, 0.0) if part == "m"
                               else (MLSTM_ATOL, MLSTM_RTOL))
            errs = {part: float((a - b).abs().max())
                    for part, (a, b, _) in pairs.items()}
            print(f"mlstm_chunk {shape} {name}: max |kernel - plain| "
                  + ", ".join(f"{part} {e:.3e} (atol {pairs[part][2][0]}, "
                              f"rtol {pairs[part][2][1]})"
                              for part, e in errs.items())
                  + f"; launches {launched}")
            if launched != 1 or y.dtype != dtype or not all(
                    torch.allclose(a, b, atol=tol[0], rtol=tol[1])
                    for a, b, tol in pairs.values()):
                raise RuntimeError(f"mlstm_chunk {shape} {name}: kernel and "
                                   f"plain version disagree")
            mlstm_err[(shape, name)] = max(errs.values())

    # 4. models on the card vs the same models on the CPU
    for cfg in ICU_WORKLOADS:
        gen_seed = 17
        gpu = ICULSTM(cfg, generator=torch.Generator().manual_seed(gen_seed),
                      device=cuda)
        cpu = ICULSTM(cfg, generator=torch.Generator().manual_seed(gen_seed),
                      device="cpu")
        x, _ = icu.generate(cfg, EXECUTE_RECORDS, seed=3)
        before = lstm_cell.launches
        with torch.inference_mode():
            lg = gpu(torch.as_tensor(x, device=cuda))
            lc = cpu(torch.as_tensor(x))
        torch.cuda.synchronize()
        launched = lstm_cell.launches - before
        err = float((lg.cpu() - lc).abs().max())
        print(f"ICULSTM {cfg.name}: logits {tuple(lg.shape)}, max |cuda - "
              f"cpu| = {err:.3e}, kernel launches {launched}")
        if lg.shape != (EXECUTE_RECORDS, cfg.num_classes) or \
                not bool(torch.isfinite(lg).all()):
            raise RuntimeError(f"{cfg.name}: bad logits {tuple(lg.shape)}")
        if not err <= MODEL_ATOL:
            raise RuntimeError(f"{cfg.name}: logits differ by {err}")
        if launched != cfg.seq_len * cfg.depth:
            raise RuntimeError(f"{cfg.name}: {launched} launches, expected "
                               f"{cfg.seq_len * cfg.depth}")

    # zamba2 at full width, one group, float32: card vs CPU
    zcfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=6,
                               num_groups=1, dtype="float32")
    zmodel = build_model(zcfg)
    zp_gpu = zmodel.init(torch.Generator(cuda).manual_seed(1), device=cuda)
    prompt = make_batch(zcfg, 1, GEN_PROMPT, seed=1)["tokens"]
    e_pre, e_dec, pre, dec = one_group_card_vs_cpu(
        torch, zmodel, zp_gpu, prompt, (flash_attention, ssm_scan),
        "zamba2 one group")
    print(f"zamba2 full width, 1 group, float32, prompt (1, {GEN_PROMPT}):"
          f" max |cuda - cpu| logits prefill {e_pre:.3e}, 4 decode steps "
          f"{e_dec:.3e} (atol = rtol = {ONE_GROUP_TOL}); "
          f"(flash, ssm) launches prefill {pre}, decode {dec}")
    if pre != (1, 5) or dec != (0, 0):
        raise RuntimeError(f"zamba2 one group: launches prefill {pre}, "
                           f"decode {dec}; expected (1, 5) and (0, 0)")
    del zp_gpu

    # xlstm-350m at full width, one group (7 mLSTM + 1 sLSTM), float32
    xcfg = dataclasses.replace(get_config("xlstm-350m"), num_layers=8,
                               num_groups=1, dtype="float32")
    xmodel = build_model(xcfg)
    xp_gpu = xmodel.init(torch.Generator(cuda).manual_seed(1), device=cuda)
    prompt = make_batch(xcfg, 1, GEN_PROMPT, seed=1)["tokens"]
    e_pre, e_dec, pre, dec = one_group_card_vs_cpu(
        torch, xmodel, xp_gpu, prompt, (mlstm_chunk,), "xlstm one group")
    print(f"xlstm-350m full width, 1 group, float32, prompt (1, "
          f"{GEN_PROMPT}): max |cuda - cpu| logits prefill {e_pre:.3e}, 4 "
          f"decode steps {e_dec:.3e} (atol = rtol = {ONE_GROUP_TOL}); "
          f"mlstm_chunk launches prefill {pre[0]}, decode {dec[0]}")
    if pre != (XLSTM_BLOCKS,) or dec != (0,):
        raise RuntimeError(f"xlstm one group: launches prefill {pre}, "
                           f"decode {dec}; expected 7 and 0")
    del xp_gpu

    # 5. device search: CUDA vs CPU on integer instances
    rng = np.random.default_rng(0)
    for n in (40, 100):
        for fleet in ((1, 1), (2, 3)):
            for objective in ("weighted", "unweighted", "last"):
                jobs = [int_instance(sim, tiers, rng, n) for _ in range(2)]
                init = [[int(a) for a in rng.integers(0, 3, n)]
                        for _ in range(2)]
                kw = dict(objective=objective, machines_per_tier=fleet)
                vg, ag = scheduler_torch.tabu_search_batched(
                    jobs, init, device=cuda, **kw)
                vc, ac = scheduler_torch.tabu_search_batched(
                    jobs, init, device="cpu", **kw)
                same = all(np.array_equal(a, b) for a, b in zip(ag, ac)) \
                    and np.array_equal(vg, vc)
                print(f"search n={n} fleet={fleet} {objective}: cuda "
                      f"{vg.tolist()} cpu {vc.tolist()} identical={same}")
                if not same:
                    raise RuntimeError("device search differs between "
                                       "CUDA and CPU")

    # 6. the main path, with every counter read around it alone
    lstm_cell.launches = 0
    scheduler_torch.tabu_search_batched.calls = 0
    t0 = time.perf_counter()
    results, lb = serve.run(patients=SERVE_PATIENTS, horizon=30.0, seed=0,
                            execute=True, verbose=False)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = lstm_cell.launches
    search_calls = scheduler_torch.tabu_search_batched.calls
    ours = results["ours (algorithm 2)"]
    for name, sched in results.items():
        print(f"serve {name:26s} weighted {sched.weighted_sum:9.0f} "
              f"unweighted {sched.unweighted_sum:9.0f} "
              f"last {sched.last_end:6.0f}")
    print(f"serve lower bound (eq.6)   {lb:9.0f}")
    print(f"serve: {len(ours.entries)} jobs in {serve_s:.2f} s, lstm_cell "
          f"launches {launches}, device-search calls {search_calls}")
    if not ours.weighted_sum >= lb - 1e-9:
        raise RuntimeError("ours is below the lower bound")
    worse = [n for n, s in results.items()
             if ours.weighted_sum > s.weighted_sum + 1e-9]
    if worse:
        raise RuntimeError(f"ours is worse than {worse}")
    if len(ours.entries) != SERVE_PATIENTS:
        raise RuntimeError(f"{len(ours.entries)} entries")
    if search_calls < 1:
        raise RuntimeError("the main path did not take the device search")
    if launches < 48 * SERVE_PATIENTS:
        raise RuntimeError(f"only {launches} lstm_cell launches")

    # 6b, 6c. the LLM serving paths, each with every counter read around
    # it alone
    kernels = {"lstm_cell": lstm_cell, "flash_attention": flash_attention,
               "ssm_scan": ssm_scan, "mlstm_chunk": mlstm_chunk}
    zcfg = get_config("zamba2-2.7b")
    zengine, zbatch, zl = drive_generate(
        torch, zcfg, kernels, {"lstm_cell": 0,
                               "flash_attention": zcfg.num_groups,
                               "ssm_scan": 5 * zcfg.num_groups,
                               "mlstm_chunk": 0}, card)
    flash_launches, ssm_launches = zl["flash_attention"], zl["ssm_scan"]
    xcfg = get_config("xlstm-350m")
    xengine, xbatch, xl = drive_generate(
        torch, xcfg, kernels, {"lstm_cell": 0, "flash_attention": 0,
                               "ssm_scan": 0,
                               "mlstm_chunk": XLSTM_BLOCKS * xcfg.num_groups},
        card)
    mlstm_launches = xl["mlstm_chunk"]

    # main-path launches per (B, I, H): calibrate runs two inferences of
    # CALIBRATE_RECORDS per workload, execution one of EXECUTE_RECORDS
    # per job
    mix = {}
    for cfg in ICU_WORKLOADS:
        steps = cfg.seq_len * cfg.depth
        mix[(CALIBRATE_RECORDS, cfg.input_dim, cfg.hidden)] = 2 * steps
        mix[(EXECUTE_RECORDS, cfg.input_dim, cfg.hidden)] = steps * sum(
            e.job.workload == cfg.name for e in ours.entries)
    if sum(mix.values()) != launches:
        raise RuntimeError(f"launch mix {sum(mix.values())} != {launches}")

    # 7. timings
    per_shape = {}
    for k, shape in enumerate(ICU_SHAPES):
        args = cell_inputs(torch, shape, cuda, seed=100 + k)
        b, i, h = shape
        w_ih = args[3].reshape(i, 4 * h).t().contiguous()
        w_hh = args[4].reshape(h, 4 * h).t().contiguous()
        b_ih, b_hh = args[5].reshape(4 * h), torch.zeros(4 * h, device=cuda)
        t = {"ms": event_ms(torch, lambda: lstm_cell(*args), 2000),
             "plain_ms": event_ms(torch, lambda: lstm_cell_plain(*args),
                                  500),
             "library_ms": event_ms(torch, lambda: torch.lstm_cell(
                 args[0], (args[1], args[2]), w_ih, w_hh, b_ih, b_hh), 500),
             "graph_ms": graph_ms(torch, lambda: lstm_cell(*args))}
        t["bytes_ms"], t["ops_ms"] = cell_bound(shape)
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] \
            else "operations"
        per_shape[shape] = t
        print(f"[{card}] lstm_cell B,I,H={shape}: kernel {t['ms']:.5f} ms, "
              f"kernel replayed from a CUDA graph {t['graph_ms']:.5f} ms, "
              f"plain {t['plain_ms']:.5f} ms, torch.lstm_cell "
              f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), main-path launches {mix[shape]}")

    q, kk, v = flash_inputs(torch, ZAMBA_ATTN, torch.bfloat16, cuda, seed=200)
    kw = flash_kwargs(ZAMBA_ATTN)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ft = {"ms": event_ms(torch, lambda: flash_attention(q, kk, v, **kw), 50,
                         warmup=5),
          "plain_ms": event_ms(torch, lambda: flash_attention_plain(
              q, kk, v, **kw), 10, warmup=2),
          "library_ms": event_ms(torch, lambda: sdpa(q, kk, v,
                                                     is_causal=True), 50,
                                 warmup=5)}
    lib_err = float((sdpa(q, kk, v, is_causal=True).float()
                     - flash_attention(q, kk, v, **kw).float()).abs().max())
    ft["bytes_ms"], ft["ops_ms"] = flash_bound(ZAMBA_ATTN, 2, BF16_FLOPS)
    print(f"[{card}] flash_attention {ZAMBA_ATTN} bf16: kernel "
          f"{ft['ms']:.5f} ms, plain {ft['plain_ms']:.5f} ms, "
          f"scaled_dot_product_attention {ft['library_ms']:.5f} ms (max "
          f"|sdpa - kernel| {lib_err:.3e}), bound bytes "
          f"{ft['bytes_ms']:.6f} ms / operations {ft['ops_ms']:.6f} ms, "
          f"main-path launches {flash_launches}")

    args = ssm_inputs(torch, ZAMBA_SSM, torch.bfloat16, cuda, seed=201)
    st = {"ms": event_ms(torch, lambda: ssm_scan(*args), 20, warmup=3),
          "plain_ms": event_ms(torch, lambda: ssm_scan_plain(*args), 3,
                               warmup=1),
          "library_ms": None}
    st["bytes_ms"], st["ops_ms"] = ssm_bound(ZAMBA_SSM, 2, BF16_FLOPS)
    print(f"[{card}] ssm_scan {ZAMBA_SSM} x/b/c bf16: kernel "
          f"{st['ms']:.5f} ms, plain {st['plain_ms']:.5f} ms, library none "
          f"(no single PyTorch call computes it), bound bytes "
          f"{st['bytes_ms']:.6f} ms / operations {st['ops_ms']:.6f} ms "
          f"(at the f32 CUDA-core rate the operations would take "
          f"{ssm_bound(ZAMBA_SSM, 2, F32_FLOPS)[1]:.6f} ms), main-path "
          f"launches {ssm_launches}")

    args = mlstm_inputs(torch, XLSTM_MLSTM, torch.bfloat16, cuda, seed=202)
    mt = {"ms": event_ms(torch, lambda: mlstm_chunk(*args), 20, warmup=3),
          "plain_ms": event_ms(torch, lambda: mlstm_chunk_plain(*args), 5,
                               warmup=2),
          "library_ms": None}
    mt["bytes_ms"], mt["ops_ms"] = mlstm_bound(XLSTM_MLSTM, 2, BF16_FLOPS)
    print(f"[{card}] mlstm_chunk {XLSTM_MLSTM} q/k/v bf16: kernel "
          f"{mt['ms']:.5f} ms, plain {mt['plain_ms']:.5f} ms, library none "
          f"(no single PyTorch call computes it), bound bytes "
          f"{mt['bytes_ms']:.6f} ms / operations {mt['ops_ms']:.6f} ms "
          f"(at the f32 CUDA-core rate the operations would take "
          f"{mlstm_bound(XLSTM_MLSTM, 2, F32_FLOPS)[1]:.6f} ms), main-path "
          f"launches {mlstm_launches}")

    def mean_over_mix(key):
        return sum(per_shape[s][key] * c for s, c in mix.items()) \
            / sum(mix.values())

    for cfg in ICU_WORKLOADS:
        gen = torch.Generator().manual_seed(5)
        engine = ClassifierEngine(ICULSTM(cfg, generator=gen, device=cuda),
                                  device=cuda)
        x, _ = icu.generate(cfg, EXECUTE_RECORDS, seed=9)
        for _ in range(3):
            engine.infer(x)
        secs = [engine.infer(x)[1] for _ in range(20)]
        print(f"[{card}] ClassifierEngine.infer {cfg.name} "
              f"B={EXECUTE_RECORDS}: median {statistics.median(secs)*1e3:.3f}"
              f" ms over 20 runs")

    jobs = int_instance(sim, tiers, np.random.default_rng(42), 100)
    mpt = {tiers.CC: 1, tiers.ES: 1}
    for label, kw in (("device search on cuda", dict(device=cuda)),
                      ("device search on cpu",
                       dict(device="cpu", device_threshold=0)),
                      ("python search", dict(device="cpu"))):
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scheduler.search(jobs, machines_per_tier=mpt, **kw)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        print(f"[{card}] scheduler.search n=100 {label}: median "
              f"{statistics.median(secs):.4f} s over 3 runs")

    # 8. where the time goes: one more main-path run under torch.profiler
    # (its counters are not read); device busy share = summed device self
    # time over the traced run's wall time, which the tracing inflates
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.run(patients=SERVE_PATIENTS, horizon=30.0, seed=0,
                  execute=True, verbose=False)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    print_profile(prof, f"[{card}] traced serve.run(patients="
                  f"{SERVE_PATIENTS})", traced_s, 8)
    trace_generate(torch, zengine, zbatch, "zamba2-2.7b", card)
    trace_generate(torch, xengine, xbatch, "xlstm-350m", card)

    print(json.dumps({"kernels": [{
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:25",
        "launches": launches, "max_abs_err": max_err,
        "ms": mean_over_mix("ms"), "plain_ms": mean_over_mix("plain_ms"),
        "bound_ms": mean_over_mix("bound_ms"),
        "bound_by": ("bytes" if mean_over_mix("bytes_ms")
                     >= mean_over_mix("ops_ms") else "operations"),
        "library_ms": mean_over_mix("library_ms")}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": flash_launches,
        "max_abs_err": flash_err[(ZAMBA_ATTN, "bfloat16")],
        "ms": ft["ms"], "plain_ms": ft["plain_ms"],
        "bound_ms": max(ft["bytes_ms"], ft["ops_ms"]),
        "bound_by": "bytes" if ft["bytes_ms"] >= ft["ops_ms"]
        else "operations",
        "library_ms": ft["library_ms"]}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:34",
        "launches": ssm_launches,
        "max_abs_err": ssm_err[(ZAMBA_SSM, "bfloat16")],
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": max(st["bytes_ms"], st["ops_ms"]),
        "bound_by": "bytes" if st["bytes_ms"] >= st["ops_ms"]
        else "operations",
        "library_ms": None}, {
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk.py:37",
        "launches": mlstm_launches,
        "max_abs_err": mlstm_err[(XLSTM_MLSTM, "bfloat16")],
        "ms": mt["ms"], "plain_ms": mt["plain_ms"],
        "bound_ms": max(mt["bytes_ms"], mt["ops_ms"]),
        "bound_by": "bytes" if mt["bytes_ms"] >= mt["ops_ms"]
        else "operations",
        "library_ms": None}]}))
    # the one card this run used, whatever else the host shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
