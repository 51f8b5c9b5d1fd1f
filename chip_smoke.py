#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel of the main path, from the sources in this
     checkout;
  3. each kernel against its plain PyTorch version on the card;
  4. the ICU LSTM models on the card (kernel path) against the same models
     on the CPU (plain path);
  5. the device tabu search on CUDA against the same search on the CPU;
  6. the main path, `repro_torch.launch.serve.run(patients=100)`: calibrate,
     strategy table, lower bound, execution; with every launch counter set
     to 0 just before it and read just after;
  7. timings with CUDA events, each printed beside the card's name and
     power limit;
  8. one more main-path run under torch.profiler: device busy share and
     the kernels that take the device's time.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the checkout, the script exits non-zero and prints no
result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 bytes/s and float32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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

    from repro_torch.configs.icu_lstm import ICU_WORKLOADS
    from repro_torch.core import scheduler, scheduler_torch
    from repro_torch.core import simulator as sim
    from repro_torch.core import tiers
    from repro_torch.data import icu
    from repro_torch.kernels import build
    from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_plain
    from repro_torch.launch import serve
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
    libs = build.build("lstm_cell")
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
    dev_us = sorted(((getattr(e, "self_device_time_total", 0.0), e.key,
                      e.count) for e in prof.key_averages()), reverse=True)
    busy_s = sum(d for d, _, _ in dev_us) / 1e6
    print(f"[{card}] traced serve.run(patients={SERVE_PATIENTS}): wall "
          f"{traced_s:.3f} s, device busy {busy_s:.4f} s "
          f"({busy_s / traced_s:.2%}); top device self time:")
    for d, key, count in dev_us[:8]:
        print(f"  {key[:64]:64s} {d / 1e3:10.3f} ms  x{count}")

    print(json.dumps({"kernels": [{
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:25",
        "launches": launches, "max_abs_err": max_err,
        "ms": mean_over_mix("ms"), "plain_ms": mean_over_mix("plain_ms"),
        "bound_ms": mean_over_mix("bound_ms"),
        "bound_by": ("bytes" if mean_over_mix("bytes_ms")
                     >= mean_over_mix("ops_ms") else "operations"),
        "library_ms": mean_over_mix("library_ms")}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
