#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA source (lstm_cell, which holds the lstm_cell step
     and lstm_sequence kernels, flash_attention, ssm_scan, mlstm_chunk),
     from this checkout, all nvcc processes at once;
  3. each kernel against its plain PyTorch version on the card, at its
     test shapes and at the shapes the main paths give it;
  4. the ICU LSTM models (depth 1, and depth 2, which passes a hidden
     sequence between layers), and zamba2 and xlstm-350m at full width
     with one group, on the card (kernel path) against the same models on
     the CPU (plain path);
  5. the device tabu search on CUDA against the same search on the CPU,
     identical on integer instances: the round regime, the pass regime
     (background-heavy ragged batches with frozen jobs and reservations),
     the device greedy init at 32 wards x 100 jobs, and the
     contention-aware `scheduler.search_fleet` at 8 wards x 40 jobs;
  6. the main paths, each with every launch counter set to 0 just before
     it and read just after:
     a. `repro_torch.launch.serve.run(patients=100)`: calibrate, strategy
        table, lower bound, execution (lstm_sequence, one launch per ICU
        inference and layer; no lstm_cell step);
     b. `ServingEngine(build_model(get_config("zamba2-2.7b"))).generate`
        at full width and depth in bf16: 4 prompts of 512 tokens, 32
        greedy steps (flash_attention, ssm_scan);
     c. the same for xlstm-350m (mlstm_chunk);
     d. `repro_torch.launch.serve.run_wards(wards=32, patients=100)` on a
        4 + 2 fleet, independent and with contention (calibration:
        lstm_sequence; planning: the batched device search);
     e. `repro_torch.launch.serve.run_metro` on the chaos packs at their
        canonical shapes, each tabu event log held to the CRC the
        reference committed in BENCH_scheduler.json, the four-ward replans
        on the batched device search; the default pack (cut to
        METRO_DEFAULT_HOURS) under tabu and fleet, identical on CUDA and
        on the host CPU; one pack with check_determinism and sanitize (no
        kernel of the four: metro builds its jobs from `metro_costs`);
  7. timings with CUDA events (and by CUDA-graph replay, the device time
     alone, for each kernel at its main-path shape), each printed beside
     the card's name and power limit, and for ssm_scan and
     mlstm_chunk the registers and spills `nvcc -Xptxas -v` reported and
     the tensor-core (HMMA) instructions in each kernel's SASS; the
     schedule searches on CUDA, on the host CPU and in Python (host clock
     after a synchronise), and the device search's kernel launches per
     pass-regime sweep (torch.profiler); the metro engine's events/s on
     CUDA and on the host CPU (phase 6e's runs);
  8. one more run of each main path under torch.profiler (metro: the
     tabu run of mass_casualty_crash): device busy share and the kernels
     that take the device's time.
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
ICU_T = 48                  # the ICU sequences' length
SEQ_TEST_T = (48, 130)      # lstm_sequence at the test shapes
# the H100's SM boost clock (data sheet), for lstm_sequence's serial
# latency estimate
SM_CLOCK_HZ = 1.98e9
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
# head dims that are not multiples of 16 (the bf16 kernel pads them with
# zero columns), a decode-like single query over 512 keys, and GQA, a
# window, softcap and ragged L together
PADDED_ATTN = [(2, 4, 2, 200, 200, 40, True, None, None),
               (1, 4, 4, 130, 130, 72, False, None, None),
               (1, 32, 32, 1, 512, 80, True, None, None),
               (2, 32, 4, 300, 300, 80, True, 64, 30.0)]
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
# fleet planning: the reference contention benchmark's fleet (4 cloud + 2
# edge machines, benchmarks/scheduler_scale.py bench_contention) and
# run_wards at 32 wards x 100 patients; the contention search held
# against the CPU at 8 x 40, and timed at FLEET_TIMED_WARDS x 100 with the
# benchmark's budgets (max_count 5, max_sweeps 4)
FLEET_MPT = (4, 2)
FLEET_WARDS, FLEET_PATIENTS = 32, 100
FLEET_CHECK = (8, 40)
FLEET_TIMED_WARDS = 4
BATCHED_TIMED_N = (100, 1000)   # search_batched's instance sizes
FLEET_TIMED_BUDGET = dict(max_count=5, max_sweeps=4)
PYTHON_ONLY = 10 ** 9           # a search threshold no instance reaches
# metro (phase 6e): the chaos packs at their canonical shapes, held to the
# event-log CRCs the reference committed in BENCH_scheduler.json (its bench
# pins the single-ward search to Python, as here); the tabu replans of
# mass_casualty_crash and degraded_network batch 4 wards onto the device
# search. The default pack runs on CUDA and on the host CPU at a cut
# horizon (METRO_DEFAULT_HOURS of its canonical 2 h)
METRO_PACKS = ("edge_brownout", "mass_casualty_crash", "degraded_network",
               "diurnal_day")
METRO_BATCHED_PACKS = ("mass_casualty_crash", "degraded_network")
METRO_POLICIES = ("greedy", "tabu", "shed")
METRO_DEFAULT_HOURS = 1.0
SLOW_RUN_S = 20.0               # a timing whose first run takes longer is
                                # reported from that one run


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


def sequence_inputs(torch, shape, t_len, device, seed):
    """xs (T, B, I) and one layer's weights, drawn as `cell_inputs` draws
    them."""
    b, i, h = shape
    g = torch.Generator().manual_seed(seed)
    s = 1.0 / (i + h) ** 0.5
    args = [torch.randn(t_len, b, i, generator=g),
            torch.randn(i, 4, h, generator=g) * s,
            torch.randn(h, 4, h, generator=g) * s,
            torch.randn(4, h, generator=g) * 0.1]
    return [a.to(device) for a in args]


def sequence_bound(shape, t_len):
    """Least time (ms) of one lstm_sequence call (one layer over T steps,
    h_T and c_T out, no sequence), as its two parts: xs and the weights
    read once and h_T, c_T written once over the HBM rate, and T steps of
    `cell_bound`'s operations over the float32 rate. The bound is the
    larger; neither sees the T dependent steps, which `serial_estimate`
    does."""
    b, i, h = shape
    nbytes = 4 * (t_len * b * i + 4 * h * (i + h) + 4 * h + 2 * b * h)
    ops = t_len * (8 * b * h * (i + h) + 25 * b * h)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def serial_estimate(shape, t_len):
    """An estimate (ms), not a bound, of the T dependent steps alone: per
    step a chain of H FMAs (4 cycles each) and the gate math's four
    dependent special-function operations (~20 cycles each), at the boost
    clock."""
    h = shape[2]
    return t_len * (4 * h + 4 * 20) / SM_CLOCK_HZ * 1e3


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


def kernel_report(build, name, kernels):
    """One line per compiled kernel of `csrc/<name>.cu` named in `kernels`:
    its registers, spills and static shared memory as `nvcc -Xptxas -v`
    printed them when it was built (the build's log), and the number of
    tensor-core instructions (HMMA) in its SASS (`cuobjdump -sass` of the
    built library)."""
    import re
    info, cur = {}, None
    for line in build.log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            info[cur] = []
        elif cur and ("spill" in line or "Used" in line):
            info[cur].append(line.split(":", 1)[-1].strip())
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hmma = {}
    for part in sass.split("Function : ")[1:]:
        hmma[part.split()[0]] = part.count("HMMA")
    lines = []
    for mangled, props in info.items():
        label = next((k for k in kernels if k in mangled), None)
        if label is None:
            continue
        width = re.search(r"ILi(\d+)E", mangled)
        label += f"<{width.group(1)}>" if width else ""
        lines.append(f"{name}.cu {label}: {'; '.join(props)}; "
                     f"{hmma.get(mangled, 0)} HMMA instructions in SASS")
    return lines


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


def int_reservations(sim, tiers, rng, per_tier=3):
    """`per_tier` integer interval reservations on each shared tier."""
    return {t: [sim.Reservation(arrival=float(r + rng.integers(0, 40)),
                                proc=float(rng.integers(1, 25)),
                                release=float(r),
                                weight=float(rng.integers(0, 4)))
                for r in rng.integers(0, 20, per_tier)]
            for t in (tiers.CC, tiers.ES)}


def metro_wards(problems, seed, wards, n, integer=True):
    """The reference contention benchmark's wards: `metro_jobs` (the
    cloud-attractive cost regime) from seeds seed, seed + 1, ...; with
    `integer`, releases rounded so every cost is an integer and the card
    and the CPU must agree exactly."""
    import numpy as np
    out = []
    for i in range(wards):
        jobs = problems.metro_jobs(np.random.default_rng(seed + i), n=n)
        if integer:
            jobs = [dataclasses.replace(j, release=float(round(j.release)))
                    for j in jobs]
        out.append(jobs)
    return out


class Spy:
    """Within `with`, records the keyword arguments of every call of
    `module.name` (and counts them), then restores it."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            self.calls.append(kwargs)
            return real(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def plans_identical(a, b):
    """Two FleetPlans with the same joint and naive plans, claims, sweep
    count and fleet-true objectives."""
    return (a.assignments == b.assignments
            and a.naive_assignments == b.naive_assignments
            and a.naive_reported == b.naive_reported
            and a.sweeps == b.sweeps
            and all(a.fleet.objective(o) == b.fleet.objective(o)
                    and a.naive_fleet.objective(o)
                    == b.naive_fleet.objective(o)
                    for o in ("weighted", "unweighted", "last")))


def host_seconds(torch, fn, card, label, reps=3):
    """Median host-clock seconds of `fn` over `reps` runs, each between
    two `torch.cuda.synchronize()`; a first run longer than SLOW_RUN_S is
    reported alone. Prints the result beside the card."""
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if secs[0] > SLOW_RUN_S:
            break
    med = statistics.median(secs)
    how = (f"median of {len(secs)} runs" if len(secs) > 1 else "one run"
           if reps == 1 else f"one run (over {SLOW_RUN_S:.0f} s, not "
           f"repeated)")
    print(f"[{card}] {label}: {med:.4f} s, {how}")
    return med


def check_device_search(torch, cuda):
    """Phase 5: the device tabu search on `cuda` against the same search
    on the CPU, identical on integer instances; raises on any
    difference."""
    import numpy as np

    from repro_torch.core import problems, scheduler, scheduler_torch
    from repro_torch.core import simulator as sim
    from repro_torch.core import tiers

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

    # the pass regime: ragged background-heavy batches, 30 % of each ward
    # frozen and 3 + 3 reservations, padded so that 2·S < rows
    for n in (40, 100):
        sizes = (n, 7 * n // 10, 4 * n // 10)
        for fleet in ((1, 1), (2, 3)):
            for objective in ("weighted", "unweighted", "last"):
                jobs = [int_instance(sim, tiers, rng, m) for m in sizes]
                init = [[int(a) for a in rng.integers(0, 3, m)]
                        for m in sizes]
                frozen = [list(rng.random(m) < 0.3) for m in sizes]
                s_slots = -(-max(m - sum(f) for m, f in zip(sizes, frozen))
                            // 16) * 16
                kw = dict(objective=objective, machines_per_tier=fleet,
                          frozen=frozen, pad_to=2 * s_slots + 16,
                          reserved=[int_reservations(sim, tiers, rng)
                                    for _ in sizes])
                with Spy(scheduler_torch, "_tabu_run_batched") as spy:
                    t0 = time.perf_counter()
                    vg, ag = scheduler_torch.tabu_search_batched(
                        jobs, init, device=cuda, **kw)
                    tg = time.perf_counter() - t0
                    vc, ac = scheduler_torch.tabu_search_batched(
                        jobs, init, device="cpu", **kw)
                modes = {c["mode"] for c in spy.calls}
                same = all(np.array_equal(a, b) for a, b in zip(ag, ac)) \
                    and np.array_equal(vg, vc)
                print(f"search pass regime sizes={sizes} rows="
                      f"{kw['pad_to']} S={s_slots} fleet={fleet} "
                      f"{objective}: cuda {vg.tolist()} cpu {vc.tolist()} "
                      f"identical={same} (cuda {tg:.2f} s)")
                if not same or modes != {"pass"}:
                    raise RuntimeError(f"pass regime: identical={same}, "
                                       f"regimes {modes}")

    # the device greedy init: 32 wards of 100 jobs, no initial
    jobs = [int_instance(sim, tiers, rng, FLEET_PATIENTS)
            for _ in range(FLEET_WARDS)]
    kw = dict(machines_per_tier=FLEET_MPT)
    for max_rounds in (0, None):
        vg, ag = scheduler_torch.tabu_search_batched(
            jobs, max_rounds=max_rounds, device=cuda, **kw)
        vc, ac = scheduler_torch.tabu_search_batched(
            jobs, max_rounds=max_rounds, device="cpu", **kw)
        same = all(np.array_equal(a, b) for a, b in zip(ag, ac)) \
            and np.array_equal(vg, vc)
        print(f"search greedy init B={FLEET_WARDS} n={FLEET_PATIENTS} "
              f"fleet={FLEET_MPT} max_rounds={max_rounds}: fleet total "
              f"cuda {vg.sum()} cpu {vc.sum()} identical={same}")
        if not same:
            raise RuntimeError("greedy init differs between CUDA and CPU")
    greedy = [scheduler.greedy_schedule(
        j, machines_per_tier={tiers.CC: FLEET_MPT[0],
                              tiers.ES: FLEET_MPT[1]}) for j in jobs]
    probe = scheduler_torch.tabu_search_batched(jobs, max_rounds=0,
                                                device=cuda, **kw)[1]
    if [[sim.MACHINES[int(t)] for t in a] for a in probe] != greedy:
        raise RuntimeError("the device greedy init is not greedy_schedule")

    # the contention-aware fleet search: the benchmark's cloud-heavy wards
    # at 8 x 40 on the 4 + 2 fleet; its batched sweeps take the pass regime
    wards = metro_wards(problems, 5000, *FLEET_CHECK)
    mpt = {tiers.CC: FLEET_MPT[0], tiers.ES: FLEET_MPT[1]}
    plans, secs, modes = {}, {}, {}
    for label, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        with Spy(scheduler_torch, "_tabu_run_batched") as spy:
            t0 = time.perf_counter()
            plans[label] = scheduler.search_fleet(
                wards, machines_per_tier=mpt, device=dev)
            secs[label] = time.perf_counter() - t0
        modes[label] = [c["mode"] for c in spy.calls]
    pg, pc = plans["cuda"], plans["cpu"]
    same = plans_identical(pg, pc)
    print(f"search_fleet {FLEET_CHECK[0]} wards x {FLEET_CHECK[1]} jobs, "
          f"fleet {FLEET_MPT}: naive claimed {pg.naive_reported} / "
          f"fleet-true {pg.naive_fleet.weighted_sum} -> "
          f"{pg.fleet.weighted_sum} after {pg.sweeps} sweeps (cpu "
          f"{pc.fleet.weighted_sum}, {pc.sweeps} sweeps), contention gap "
          f"{pg.contention_gap:.4f}, gap closed {pg.gap_closed:.4f}, "
          f"regimes {modes['cuda']}, identical={same} (cuda "
          f"{secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s)")
    if not same or modes["cuda"] != modes["cpu"] \
            or "pass" not in modes["cuda"] or not pg.contention_gap > 1:
        raise RuntimeError("search_fleet: CUDA and CPU plans differ, no "
                           "sweep took the pass regime or no contention")


def drive_fleet(torch, kernels, card):
    """Phase 6d: run_wards on the card, independent and with contention,
    every counter of `kernels` and the device search's call count
    read around each run alone. Returns {mode: (planning seconds,
    lstm_sequence launches)}."""
    from repro_torch.configs.icu_lstm import ICU_WORKLOADS
    from repro_torch.core import scheduler_torch
    from repro_torch.launch import serve

# 6d. the fleet path: run_wards at 32 wards x 100 patients on the
    # 4 + 2 fleet, independent and with contention, every counter read
    # around each run alone. Calibration runs each ICU model twice (one
    # lstm_sequence launch per inference and layer); planning goes through
    # the batched device search
    fleet_runs = {}
    for contention in (False, True):
        for k in kernels.values():
            k.launches = 0
        scheduler_torch.tabu_search_batched.calls = 0
        t0 = time.perf_counter()
        out = serve.run_wards(
            wards=FLEET_WARDS, patients=FLEET_PATIENTS,
            cloud_machines=FLEET_MPT[0], edge_machines=FLEET_MPT[1],
            contention=contention, verbose=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {name: k.launches for name, k in kernels.items()}
        calls = scheduler_torch.tabu_search_batched.calls
        schedules, plan_s = out[0], out[1]
        label = "contention" if contention else "independent"
        total = sum(s_.weighted_sum for s_ in schedules)
        line = (f"run_wards {label} {FLEET_WARDS} wards x {FLEET_PATIENTS} "
                f"patients, fleet {FLEET_MPT}: fleet total weighted "
                f"{total:.0f}")
        bad = len(schedules) != FLEET_WARDS or any(
            len(s_.entries) != FLEET_PATIENTS for s_ in schedules)
        if contention:
            plan = out[2]
            line += (f", naive claimed {plan.naive_reported:.0f}, naive "
                     f"fleet-true {plan.naive_fleet.weighted_sum:.0f}, "
                     f"contention gap {plan.contention_gap:.4f}, gap "
                     f"closed {plan.gap_closed:.4f}, {plan.sweeps} sweeps")
            bad |= plan.fleet.weighted_sum > plan.naive_fleet.weighted_sum \
                or plan.contention_gap < 1
        print(f"{line}; tiers used "
              f"{sorted({e.machine for s_ in schedules for e in s_.entries})}"
              f"; launches {launched}, device-search calls {calls}")
        print(f"[{card}] run_wards {label}: planning {plan_s:.4f} s (host "
              f"clock, after the warm-up call), whole call {wall:.2f} s")
        want = 2 * len(ICU_WORKLOADS) * ICU_WORKLOADS[0].depth
        if bad or calls < 1 or launched != dict(
                {name: 0 for name in kernels}, lstm_sequence=want):
            raise RuntimeError(f"run_wards {label}: launches {launched} "
                               f"(expected {want} lstm_sequence and no "
                               f"other), {calls} device-search calls, or a "
                               f"bad plan")
        fleet_runs[label] = (plan_s, launched["lstm_sequence"])
    return fleet_runs


def committed_metro_crcs():
    """{run label: event-log CRC} as the reference's benchmark committed
    them (a data file, read with json)."""
    bench = json.loads((ROOT / "BENCH_scheduler.json").read_text())
    out = {pack: bench["metro_scenarios"][pack]["event_log_hash_tabu"]
           for pack in METRO_PACKS}
    for hedged in (False, True):
        key = "hedged" if hedged else "unhedged"
        out[f"fail_slow_tail {key}"] = \
            bench["metro_hedging"][f"event_log_hash_{key}"]
    return out


def metro_summary_line(label, res, seconds):
    """One line per policy run: events, events/s, device searches and
    the event-log CRC."""
    return (f"{label}: {res['events']} events, "
            f"{res['events_per_s']:.1f} events/s (engine clock; the "
            f"run_metro call with all its policies {seconds:.3f} s), "
            f"device searches {res['device_searches']}, miss rate "
            f"{res['miss_rate']:.4f}, crc {res['event_log_hash']}")


def drive_metro(torch, kernels, card):
    """Phase 6e: `serve.run_metro` on the card, every counter read around
    the whole phase alone. (a) each chaos pack (and fail_slow_tail
    hedged and unhedged under tabu) gives the reference's committed
    event-log CRC; (b) the default pack under tabu and fleet gives the
    same event log on CUDA and as torch on the host CPU; (c) one pack
    with check_determinism and sanitize on CUDA. Returns {label: (events
    per s on CUDA, events per s on the host CPU or None, device
    searches)} for phase 7."""
    from repro_torch.core import scheduler_torch
    from repro_torch.launch import serve

    want = committed_metro_crcs()
    for k in kernels.values():
        k.launches = 0
    scheduler_torch.tabu_search_batched.calls = 0
    rates, bad = {}, []

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = serve.run_metro(verbose=False, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # (a) the committed CRCs, single-ward search pinned to Python as the
    # reference's benchmark pins it
    runs = [(pack, dict(scenario=pack, policies=METRO_POLICIES))
            for pack in METRO_PACKS]
    runs += [(f"fail_slow_tail {'hedged' if h else 'unhedged'}",
              dict(scenario="fail_slow_tail", policies=("tabu",), hedge=h))
             for h in (False, True)]
    for label, kw in runs:
        out, secs = timed(device_threshold=PYTHON_ONLY, device="cuda", **kw)
        for name, res in out.items():
            print(metro_summary_line(f"metro {label} {name} cuda", res,
                                     secs))
        tabu = out["tabu"]
        ok = tabu["event_log_hash"] == want[label]
        print(f"metro {label}: tabu crc {tabu['event_log_hash']}, "
              f"committed {want[label]}, equal={ok}")
        if not ok:
            bad.append(f"{label}: crc {tabu['event_log_hash']} != "
                       f"{want[label]}")
        on_cpu = None
        if label in METRO_BATCHED_PACKS:
            if tabu["device_searches"] < 1:
                bad.append(f"{label}: no batched device search on the card")
            # the same tabu run as torch on the host CPU, for phase 7
            cpu_out, cpu_secs = timed(device_threshold=PYTHON_ONLY,
                                      device="cpu", scenario=label,
                                      policies=("tabu",))
            print(metro_summary_line(f"metro {label} tabu cpu",
                                     cpu_out["tabu"], cpu_secs))
            if cpu_out["tabu"]["event_log_hash"] != want[label]:
                bad.append(f"{label}: host cpu crc differs")
            on_cpu = cpu_out["tabu"]["events_per_s"]
        rates[label] = (tabu["events_per_s"], on_cpu,
                        tabu["device_searches"])

    # (b) the default pack, cut to METRO_DEFAULT_HOURS: CUDA and torch on
    # the host CPU with the same pinned single-ward dispatch
    for policy in ("tabu", "fleet"):
        got = {}
        for dev in ("cuda", "cpu"):
            out, secs = timed(scenario="default", policies=(policy,),
                              hours=METRO_DEFAULT_HOURS,
                              device_threshold=PYTHON_ONLY, device=dev)
            got[dev] = out[policy]
            print(metro_summary_line(
                f"[{card}] metro default {METRO_DEFAULT_HOURS:g} h "
                f"{policy} {dev}", got[dev], secs))
        same = {k: v for k, v in got["cuda"].items()
                if k not in ("seconds", "events_per_s")} == \
            {k: v for k, v in got["cpu"].items()
             if k not in ("seconds", "events_per_s")}
        print(f"metro default {policy}: cuda and cpu summaries and "
              f"event-log crc identical={same}")
        if not same or got["cuda"]["device_searches"] < 1:
            bad.append(f"default {policy}: identical={same}, device "
                       f"searches {got['cuda']['device_searches']}")
        rates[f"default {METRO_DEFAULT_HOURS:g} h {policy}"] = (
            got["cuda"]["events_per_s"], got["cpu"]["events_per_s"],
            got["cuda"]["device_searches"])

    # (c) determinism and the runtime sanitizer on the card
    out, secs = timed(scenario="mass_casualty_crash",
                      policies=METRO_POLICIES, check_determinism=True,
                      sanitize=True, device="cuda")
    ok = out["tabu"]["event_log_hash"] == want["mass_casualty_crash"]
    print(f"metro mass_casualty_crash check_determinism + sanitize on "
          f"cuda: {len(out)} policies x 2 runs bit-identical, no "
          f"violation, tabu crc equal to committed={ok} ({secs:.2f} s)")
    if not ok:
        bad.append("check_determinism run: crc differs")

    launched = {name: k.launches for name, k in kernels.items()}
    calls = scheduler_torch.tabu_search_batched.calls
    print(f"metro phase: kernel launches {launched}, device-search calls "
          f"{calls}")
    if any(launched.values()) or calls < 1:
        bad.append(f"launches {launched}, {calls} device-search calls")
    if bad:
        raise RuntimeError("metro: " + "; ".join(bad))
    return rates


def time_fleet(torch, cuda, card):
    """Phase 7's fleet planning timings (search_batched, search_fleet)
    on `cuda`, torch on the host CPU and the Python search, and the
    device search's launches in one pass-regime sweep."""
    import numpy as np

    from repro_torch.core import problems, scheduler, scheduler_torch
    from repro_torch.core import simulator as sim
    from repro_torch.core import tiers

    mpt_fleet = {tiers.CC: FLEET_MPT[0], tiers.ES: FLEET_MPT[1]}
    # fleet planning on the 4 + 2 fleet: the batched device search on CUDA
    # and on the host CPU, and the Python search looped per ward (no
    # device search). n = 1000 runs at B = 1 only if B = 32 takes over
    # 60 s on CUDA
    cpu = torch.device("cpu")
    backends = (("cuda", dict(min_batch=1, device=cuda)),
                ("torch on the host cpu", dict(min_batch=1, device=cpu)),
                ("python", dict(min_batch=PYTHON_ONLY,
                                device_threshold=PYTHON_ONLY, device=cpu)))
    batched_s = {}
    small, large = BATCHED_TIMED_N
    for n, sizes in ((small, (1, 32)), (large, (32, 1))):
        for B in sizes:
            if (n, B) == (large, 1) and batched_s[(large, 32, "cuda")] <= 60:
                print(f"search_batched n={large} B=1 not run: B=32 took "
                      f"{batched_s[(large, 32, 'cuda')]:.1f} s on CUDA")
                continue
            jobs = [int_instance(sim, tiers, np.random.default_rng(7000 + i),
                                 n) for i in range(B)]
            for label, kw in backends:
                if (n, B, label) == (large, 32, "torch on the host cpu") \
                        and batched_s[(large, 32, "cuda")] > 60:
                    break
                batched_s[(n, B, label)] = host_seconds(
                    torch, lambda: scheduler.search_batched(
                        jobs, machines_per_tier=mpt_fleet, **kw), card,
                    f"search_batched B={B} n={n} fleet {FLEET_MPT} {label}")

    # the device search's launches in one pass-regime sweep: the batched
    # replan of phase 5's 8 x 40 fleet against the other wards' cloud jobs
    # of its naive plan, as search_fleet's first sweep makes it
    from torch.profiler import ProfilerActivity, profile
    wards = metro_wards(problems, 5000, *FLEET_CHECK)
    naive = [s_.assignment() for s_ in scheduler.search_batched(
        wards, machines_per_tier=mpt_fleet, device=cuda)]
    resv = scheduler._fleet_reservations(wards, naive, (tiers.CC,))
    rows = max(len(w) + sum(len(v) for v in r.values())
               for w, r in zip(wards, resv))
    sweep_kw = dict(max_rounds=2, machines_per_tier=FLEET_MPT,
                    reserved=resv, pad_to=-(-rows // 64) * 64, device=cuda)
    init = [[sim.MACHINES.index(t) for t in a] for a in naive]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scheduler_torch.tabu_search_batched(wards, init, **sweep_kw)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    with Spy(scheduler_torch, "_round_batched") as evals, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        scheduler_torch.tabu_search_batched(wards, init, **sweep_kw)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    stats = prof.key_averages()
    sweep_launches = sum(e.count for e in stats
                         if e.key == "cudaLaunchKernel")
    device_events = sum(e.count for e in stats
                        if e.device_type != DeviceType.CPU)
    device_s = sum(e.self_device_time_total for e in stats
                   if e.device_type != DeviceType.CPU) / 1e6
    sweep_evals = len(evals.calls)
    per_eval = sweep_launches / max(sweep_evals, 1)
    print(f"[{card}] one pass-regime sweep (tabu_search_batched, "
          f"max_rounds 2), {FLEET_CHECK[0]} wards x {FLEET_CHECK[1]} jobs, "
          f"{sweep_kw['pad_to']} rows, fleet {FLEET_MPT}: {sweep_launches} "
          f"kernel launches (cudaLaunchKernel; {device_events} device "
          f"events, {device_s:.4f} s of device time) in {sweep_evals} delta "
          f"evaluations ({per_eval:.0f} launches per evaluation, "
          f"{per_eval / sweep_kw['pad_to']:.2f} per row); untraced "
          f"{sweep_s:.3f} s, {sweep_s / max(sweep_launches, 1) * 1e6:.2f} "
          f"us per launch")

    # the ward count of the timed search_fleet: the first sweep's padded
    # rows at 32, 16, 8 and 4 of the benchmark's wards, and what one sweep
    # (2 passes over the ward's movable slots) would take at the launch
    # rate just measured
    for w in (32, 16, 8, 4):
        wards = metro_wards(problems, 5000, w, FLEET_PATIENTS, integer=False)
        naive = [s_.assignment() for s_ in scheduler.search_batched(
            wards, machines_per_tier=mpt_fleet, max_count=5, device=cuda)]
        resv = scheduler._fleet_reservations(wards, naive, (tiers.CC,))
        rows = max(len(wd) + sum(len(v) for v in r.values())
                   for wd, r in zip(wards, resv))
        pad = -(-rows // 64) * 64
        slots = -(-FLEET_PATIENTS // 16) * 16
        launches_est = 2 * slots * per_eval / sweep_kw["pad_to"] * pad
        print(f"search_fleet at {w} wards x {FLEET_PATIENTS}: first sweep "
              f"{rows} rows ({pad} padded), {slots} movable slots: one "
              f"sweep ~{launches_est / 1e6:.2f} M launches, ~"
              f"{launches_est * sweep_s / max(sweep_launches, 1):.0f} s on "
              f"CUDA at the measured launch rate")

    # search_fleet on the benchmark's cloud-heavy wards (its float
    # releases), FLEET_TIMED_WARDS x 100 jobs, with the benchmark's
    # budgets: CUDA and torch on the host CPU once each, the Python
    # backend (Python naive stage and sweeps) median of 3
    wards = metro_wards(problems, 5000, FLEET_TIMED_WARDS, FLEET_PATIENTS,
                        integer=False)
    fleet_s = {}
    for label, kw in (("cuda", dict(device=cuda)),
                      ("torch on the host cpu", dict(device=cpu)),
                      ("python", dict(sweep_backend="python",
                                      min_batch=PYTHON_ONLY,
                                      device_threshold=PYTHON_ONLY,
                                      device=cpu))):
        res = {}
        fleet_s[label] = host_seconds(
            torch, lambda: res.setdefault("plan", scheduler.search_fleet(
                wards, machines_per_tier=mpt_fleet, **FLEET_TIMED_BUDGET,
                **kw)), card,
            f"search_fleet {FLEET_TIMED_WARDS} wards x {FLEET_PATIENTS} "
            f"fleet {FLEET_MPT} max_count 5 max_sweeps 4 {label}",
            reps=1 if label != "python" else 3)
        plan = res["plan"]
        print(f"  {label}: naive claimed {plan.naive_reported:.1f}, naive "
              f"fleet-true {plan.naive_fleet.weighted_sum:.1f}, fleet-true "
              f"{plan.fleet.weighted_sum:.1f} after {plan.sweeps} sweeps "
              f"(gap {plan.contention_gap:.4f}, closed "
              f"{plan.gap_closed:.4f})")



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
    from repro_torch.kernels.lstm_cell import (lstm_cell, lstm_cell_plain,
                                               lstm_sequence,
                                               lstm_sequence_plain)
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

    # lstm_sequence: a whole layer in one launch, h_T, c_T and the hidden
    # sequence against the scanned plain cell
    seq_err = 0.0
    for k, (shape, t_len) in enumerate(
            [(s_, ICU_T) for s_ in ICU_SHAPES]
            + [(s_, t) for s_ in TEST_SHAPES for t in SEQ_TEST_T]):
        args = sequence_inputs(torch, shape, t_len, cuda, seed=400 + k)
        before = lstm_sequence.launches
        hk, ck, hsk = lstm_sequence(*args, return_sequence=True)
        launched = lstm_sequence.launches - before
        hp, cp, hsp = lstm_sequence_plain(*args, return_sequence=True)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max())
                  for a, b in ((hk, hp), (ck, cp), (hsk, hsp)))
        print(f"lstm_sequence {shape} T={t_len}: max |kernel - plain| "
              f"(h_T, c_T, sequence) = {err:.3e}; launches {launched}")
        if launched != 1 or hsk.shape != hsp.shape or not err <= KERNEL_ATOL:
            raise RuntimeError(f"lstm_sequence {shape} T={t_len}: error "
                               f"{err} > {KERNEL_ATOL} or {launched} "
                               f"launches")
        seq_err = max(seq_err, err)

    flash_err = {}
    for k, case in enumerate(ATTN_CASES + [ZAMBA_ATTN] + RAGGED_ATTN
                             + PADDED_ATTN):
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

    # 4. models on the card vs the same models on the CPU: the three ICU
    # workloads as configured (depth 1) and stacked to depth 2
    for cfg in [c for base in ICU_WORKLOADS
                for c in (base, dataclasses.replace(base, depth=2))]:
        gen_seed = 17
        gpu = ICULSTM(cfg, generator=torch.Generator().manual_seed(gen_seed),
                      device=cuda)
        cpu = ICULSTM(cfg, generator=torch.Generator().manual_seed(gen_seed),
                      device="cpu")
        x, _ = icu.generate(cfg, EXECUTE_RECORDS, seed=3)
        before = (lstm_sequence.launches, lstm_cell.launches)
        with torch.inference_mode():
            lg = gpu(torch.as_tensor(x, device=cuda))
            lc = cpu(torch.as_tensor(x))
        torch.cuda.synchronize()
        launched = (lstm_sequence.launches - before[0],
                    lstm_cell.launches - before[1])
        err = float((lg.cpu() - lc).abs().max())
        print(f"ICULSTM {cfg.name} depth {cfg.depth}: logits "
              f"{tuple(lg.shape)}, max |cuda - cpu| = {err:.3e}, "
              f"(lstm_sequence, lstm_cell) launches {launched}")
        if lg.shape != (EXECUTE_RECORDS, cfg.num_classes) or \
                not bool(torch.isfinite(lg).all()):
            raise RuntimeError(f"{cfg.name}: bad logits {tuple(lg.shape)}")
        if not err <= MODEL_ATOL:
            raise RuntimeError(f"{cfg.name}: logits differ by {err}")
        if launched != (cfg.depth, 0):
            raise RuntimeError(f"{cfg.name} depth {cfg.depth}: launches "
                               f"{launched}, expected ({cfg.depth}, 0)")

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
    check_device_search(torch, cuda)

    # 6. the main path, with every counter read around it alone
    lstm_cell.launches = 0
    lstm_sequence.launches = 0
    scheduler_torch.tabu_search_batched.calls = 0
    t0 = time.perf_counter()
    results, lb = serve.run(patients=SERVE_PATIENTS, horizon=30.0, seed=0,
                            execute=True, verbose=False)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = lstm_sequence.launches
    step_launches = lstm_cell.launches
    search_calls = scheduler_torch.tabu_search_batched.calls
    ours = results["ours (algorithm 2)"]
    for name, sched in results.items():
        print(f"serve {name:26s} weighted {sched.weighted_sum:9.0f} "
              f"unweighted {sched.unweighted_sum:9.0f} "
              f"last {sched.last_end:6.0f}")
    print(f"serve lower bound (eq.6)   {lb:9.0f}")
    print(f"serve: {len(ours.entries)} jobs, untraced serve.run "
          f"{serve_s:.4f} s [{card}], lstm_sequence launches {launches}, "
          f"lstm_cell launches {step_launches}, device-search calls "
          f"{search_calls}")
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
    # one inference per job, two per workload in calibrate, each one
    # launch per layer (depth 1)
    want = (SERVE_PATIENTS + 2 * len(ICU_WORKLOADS)) * ICU_WORKLOADS[0].depth
    if (launches, step_launches) != (want, 0):
        raise RuntimeError(f"serve.run: lstm_sequence launches {launches}, "
                           f"lstm_cell launches {step_launches}; expected "
                           f"{want} and 0")

    # 6b, 6c. the LLM serving paths, each with every counter read around
    # it alone
    kernels = {"lstm_cell": lstm_cell, "lstm_sequence": lstm_sequence,
               "flash_attention": flash_attention, "ssm_scan": ssm_scan,
               "mlstm_chunk": mlstm_chunk}
    zcfg = get_config("zamba2-2.7b")
    zengine, zbatch, zl = drive_generate(
        torch, zcfg, kernels, {"lstm_cell": 0, "lstm_sequence": 0,
                               "flash_attention": zcfg.num_groups,
                               "ssm_scan": 5 * zcfg.num_groups,
                               "mlstm_chunk": 0}, card)
    flash_launches, ssm_launches = zl["flash_attention"], zl["ssm_scan"]
    xcfg = get_config("xlstm-350m")
    xengine, xbatch, xl = drive_generate(
        torch, xcfg, kernels, {"lstm_cell": 0, "lstm_sequence": 0,
                               "flash_attention": 0, "ssm_scan": 0,
                               "mlstm_chunk": XLSTM_BLOCKS * xcfg.num_groups},
        card)
    mlstm_launches = xl["mlstm_chunk"]

    # 6d. the fleet path (its counters read around each run alone)
    fleet_runs = drive_fleet(torch, kernels, card)

    # 6e. the metro engine (its counters read around the phase alone)
    metro_rates = drive_metro(torch, kernels, card)

    # main-path lstm_sequence launches per (B, I, H): calibrate runs two
    # inferences of CALIBRATE_RECORDS per workload, execution one of
    # EXECUTE_RECORDS per job, each one launch per layer
    mix = {}
    for cfg in ICU_WORKLOADS:
        mix[(CALIBRATE_RECORDS, cfg.input_dim, cfg.hidden)] = 2 * cfg.depth
        mix[(EXECUTE_RECORDS, cfg.input_dim, cfg.hidden)] = cfg.depth * sum(
            e.job.workload == cfg.name for e in ours.entries)
    if sum(mix.values()) != launches:
        raise RuntimeError(f"launch mix {sum(mix.values())} != {launches}")

    # 7. timings. lstm_cell has no launch on the main path any more; its
    # times are averaged over the ICU shapes with lstm_sequence's
    # main-path mix as the weights
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
              f"({t['bound_by']}), main-path launches 0")

    # lstm_sequence per forward (one layer, T = 48, h_T and c_T out, as
    # ICULSTM's depth-1 layer calls it); cuDNN's LSTM (torch.nn.LSTM, TF32
    # off) computes the same function as the library yardstick
    per_seq = {}
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for k, shape in enumerate(ICU_SHAPES):
        args = sequence_inputs(torch, shape, ICU_T, cuda, seed=500 + k)
        b, i, h = shape
        lstm = torch.nn.LSTM(i, h).to(cuda)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(args[1].reshape(i, 4 * h).t())
            lstm.weight_hh_l0.copy_(args[2].reshape(h, 4 * h).t())
            lstm.bias_ih_l0.copy_(args[3].reshape(4 * h))
            lstm.bias_hh_l0.zero_()
        with torch.inference_mode():
            _, (h_lib, _) = lstm(args[0])
            lib_err = float((h_lib[0] - lstm_sequence(*args)[0]).abs().max())
            t = {"ms": event_ms(torch, lambda: lstm_sequence(*args), 1000),
                 "graph_ms": graph_ms(torch, lambda: lstm_sequence(*args)),
                 "plain_ms": event_ms(torch, lambda: lstm_sequence_plain(
                     *args), 50, warmup=5),
                 "library_ms": event_ms(torch, lambda: lstm(args[0]), 500)}
        t["bytes_ms"], t["ops_ms"] = sequence_bound(shape, ICU_T)
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] \
            else "operations"
        t["serial_ms"] = serial_estimate(shape, ICU_T)
        per_seq[shape] = t
        print(f"[{card}] lstm_sequence B,I,H={shape} T={ICU_T}: kernel "
              f"{t['ms']:.5f} ms, kernel replayed from a CUDA graph "
              f"{t['graph_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
              f"cuDNN nn.LSTM {t['library_ms']:.5f} ms (max |cudnn - "
              f"kernel| h_T {lib_err:.3e}), bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), serial-latency estimate "
              f"{t['serial_ms']:.5f} ms, main-path launches {mix[shape]}")
    torch.backends.cudnn.allow_tf32 = allow_tf32

    q, kk, v = flash_inputs(torch, ZAMBA_ATTN, torch.bfloat16, cuda, seed=200)
    kw = flash_kwargs(ZAMBA_ATTN)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ft = {"ms": event_ms(torch, lambda: flash_attention(q, kk, v, **kw), 50,
                         warmup=5),
          "graph_ms": graph_ms(torch, lambda: flash_attention(q, kk, v, **kw),
                               per_graph=20),
          "plain_ms": event_ms(torch, lambda: flash_attention_plain(
              q, kk, v, **kw), 10, warmup=2),
          "library_ms": event_ms(torch, lambda: sdpa(q, kk, v,
                                                     is_causal=True), 50,
                                 warmup=5),
          "library_graph_ms": graph_ms(torch, lambda: sdpa(
              q, kk, v, is_causal=True), per_graph=20)}
    lib_err = float((sdpa(q, kk, v, is_causal=True).float()
                     - flash_attention(q, kk, v, **kw).float()).abs().max())
    ft["bytes_ms"], ft["ops_ms"] = flash_bound(ZAMBA_ATTN, 2, BF16_FLOPS)
    print(f"[{card}] flash_attention {ZAMBA_ATTN} bf16 (tensor cores): "
          f"kernel {ft['ms']:.5f} ms (CUDA graph {ft['graph_ms']:.5f} ms), "
          f"plain {ft['plain_ms']:.5f} ms, scaled_dot_product_attention "
          f"{ft['library_ms']:.5f} ms (CUDA graph "
          f"{ft['library_graph_ms']:.5f} ms; max |sdpa - kernel| "
          f"{lib_err:.3e}), kernel / sdpa {ft['ms'] / ft['library_ms']:.3f}"
          f", bound bytes {ft['bytes_ms']:.6f} ms / operations "
          f"{ft['ops_ms']:.6f} ms, main-path launches {flash_launches}")
    q, kk, v = flash_inputs(torch, ZAMBA_ATTN, torch.float32, cuda, seed=200)
    f32_ms = event_ms(torch, lambda: flash_attention(q, kk, v, **kw), 20,
                      warmup=3)
    f32_sdpa = event_ms(torch, lambda: sdpa(q, kk, v, is_causal=True), 20,
                        warmup=3)
    print(f"[{card}] flash_attention {ZAMBA_ATTN} float32 (CUDA cores): "
          f"kernel {f32_ms:.5f} ms, scaled_dot_product_attention "
          f"{f32_sdpa:.5f} ms, bound bytes "
          f"{flash_bound(ZAMBA_ATTN, 4, F32_FLOPS)[0]:.6f} ms / operations "
          f"{flash_bound(ZAMBA_ATTN, 4, F32_FLOPS)[1]:.6f} ms")

    # ssm_scan and mlstm_chunk: the bf16 tensor-core kernels at the main
    # paths' shapes (events; CUDA-graph replay, the device time alone), the
    # float32 CUDA-core kernels at the same shapes, and what the compiler
    # made of them
    for name, kinds in (("ssm_scan", ("ssm_bf16_kernel", "ssm_f32_kernel")),
                        ("mlstm_chunk", ("mlstm_bf16_kernel",
                                         "mlstm_f32_kernel"))):
        for line in kernel_report(build, name, kinds):
            print(f"[{card}] {line}")
    # dynamic shared memory the bf16 launches request (bf16_smem_bytes in
    # each source): ssm_scan at N = 64, mlstm_chunk at D = 512
    ssm_smem = 2 * (2 * 64 * 72 + 6 * 64 * 72) + 4 * 2 * 64
    mlstm_smem = 2 * (2 * 512 + 8 * 64) * 72 + 4 * (2 * 512 + 8 * 64 + 4)
    print(f"[{card}] dynamic shared memory per block: ssm_bf16_kernel<64> "
          f"{ssm_smem} B (4 warps), mlstm_bf16_kernel {mlstm_smem} B (8 "
          f"warps)")

    args = ssm_inputs(torch, ZAMBA_SSM, torch.bfloat16, cuda, seed=201)
    st = {"ms": event_ms(torch, lambda: ssm_scan(*args), 50, warmup=5),
          "graph_ms": graph_ms(torch, lambda: ssm_scan(*args), per_graph=20),
          "plain_ms": event_ms(torch, lambda: ssm_scan_plain(*args), 3,
                               warmup=1),
          "library_ms": None}
    st["bytes_ms"], st["ops_ms"] = ssm_bound(ZAMBA_SSM, 2, BF16_FLOPS)
    args32 = [t.float() for t in args]
    ssm_f32_ms = event_ms(torch, lambda: ssm_scan(*args32), 20, warmup=3)
    print(f"[{card}] ssm_scan {ZAMBA_SSM} x/b/c bf16 (tensor cores): kernel "
          f"{st['ms']:.5f} ms (CUDA graph {st['graph_ms']:.5f} ms), "
          f"float32 (CUDA cores) {ssm_f32_ms:.5f} ms, plain "
          f"{st['plain_ms']:.5f} ms, library none (no single PyTorch call "
          f"computes it), bound bytes {st['bytes_ms']:.6f} ms / operations "
          f"{st['ops_ms']:.6f} ms (at the f32 CUDA-core rate the operations "
          f"would take {ssm_bound(ZAMBA_SSM, 2, F32_FLOPS)[1]:.6f} ms), "
          f"kernel / bound {st['ms'] / max(st['bytes_ms'], st['ops_ms']):.2f}"
          f", main-path launches {ssm_launches}")

    args = mlstm_inputs(torch, XLSTM_MLSTM, torch.bfloat16, cuda, seed=202)
    mt = {"ms": event_ms(torch, lambda: mlstm_chunk(*args), 50, warmup=5),
          "graph_ms": graph_ms(torch, lambda: mlstm_chunk(*args),
                               per_graph=20),
          "plain_ms": event_ms(torch, lambda: mlstm_chunk_plain(*args), 5,
                               warmup=2),
          "library_ms": None}
    mt["bytes_ms"], mt["ops_ms"] = mlstm_bound(XLSTM_MLSTM, 2, BF16_FLOPS)
    args32 = [t.float() for t in args]
    mlstm_f32_ms = event_ms(torch, lambda: mlstm_chunk(*args32), 20, warmup=3)
    print(f"[{card}] mlstm_chunk {XLSTM_MLSTM} q/k/v bf16 (tensor cores): "
          f"kernel {mt['ms']:.5f} ms (CUDA graph {mt['graph_ms']:.5f} ms), "
          f"float32 (CUDA cores) {mlstm_f32_ms:.5f} ms, plain "
          f"{mt['plain_ms']:.5f} ms, library none (no single PyTorch call "
          f"computes it), bound bytes {mt['bytes_ms']:.6f} ms / operations "
          f"{mt['ops_ms']:.6f} ms (at the f32 CUDA-core rate the operations "
          f"would take {mlstm_bound(XLSTM_MLSTM, 2, F32_FLOPS)[1]:.6f} ms), "
          f"kernel / bound {mt['ms'] / max(mt['bytes_ms'], mt['ops_ms']):.2f}"
          f", main-path launches {mlstm_launches}")

    def mean_over_mix(table, key):
        return sum(table[s][key] * c for s, c in mix.items()) \
            / sum(mix.values())

    def bound_by(table):
        return ("bytes" if mean_over_mix(table, "bytes_ms")
                >= mean_over_mix(table, "ops_ms") else "operations")

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

    time_fleet(torch, cuda, card)

    # the metro engine's throughput (engine clock, phase 6e's runs): the
    # tabu run of each pack on CUDA, and the default pack's cut runs on
    # CUDA and as torch on the host CPU
    for label, (on_cuda, on_cpu, searches) in metro_rates.items():
        cpu_part = ("" if on_cpu is None
                    else f", host cpu {on_cpu:.1f} events/s")
        print(f"[{card}] metro {label}: cuda {on_cuda:.1f} events/s"
              f"{cpu_part}, {searches} device searches")

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
    # the metro path: the tabu run of the pack whose four-ward replans
    # take the most batched device searches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.run_metro(scenario=METRO_BATCHED_PACKS[0], policies=("tabu",),
                        device_threshold=PYTHON_ONLY, device="cuda",
                        verbose=False)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    print_profile(prof, f"[{card}] traced run_metro({METRO_BATCHED_PACKS[0]}"
                  f", tabu)", traced_s, 8)
    trace_generate(torch, zengine, zbatch, "zamba2-2.7b", card)
    trace_generate(torch, xengine, xbatch, "xlstm-350m", card)

    print(json.dumps({"kernels": [{
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:25",
        "launches": step_launches, "max_abs_err": max_err,
        "ms": mean_over_mix(per_shape, "ms"),
        "plain_ms": mean_over_mix(per_shape, "plain_ms"),
        "bound_ms": mean_over_mix(per_shape, "bound_ms"),
        "bound_by": bound_by(per_shape),
        "library_ms": mean_over_mix(per_shape, "library_ms")}, {
        "name": "lstm_sequence", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:25, scanned by "
                    "src/repro/models/lstm.py:52-58",
        "launches": launches + sum(n for _, n in fleet_runs.values()),
        "max_abs_err": seq_err,
        "ms": mean_over_mix(per_seq, "ms"),
        "plain_ms": mean_over_mix(per_seq, "plain_ms"),
        "bound_ms": mean_over_mix(per_seq, "bound_ms"),
        "bound_by": bound_by(per_seq),
        "library_ms": mean_over_mix(per_seq, "library_ms")}, {
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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
