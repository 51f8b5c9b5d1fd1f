#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA source (lstm_cell, which holds the lstm_cell step
     and the lstm_sequence forward and backward kernels, flash_attention,
     flash_attention_bwd, ssm_scan, ssm_scan_bwd, mlstm_chunk,
     mlstm_chunk_bwd), from this checkout, all nvcc processes at once;
  3. each kernel against its plain PyTorch version on the card, at its
     test shapes and at the shapes the main paths give it (lstm_cell and
     lstm_sequence also on bf16 inputs; flash_attention also with more
     queries than keys, at the bf16 kernels' tensor-map edges and on
     views whose base is or is not 16-byte aligned); the training
     forwards' records and the four backward kernels
     (lstm_sequence_backward, flash_attention_backward, ssm_scan_backward,
     mlstm_chunk_backward) against their plain versions, float32 and bf16,
     each also bit-equal on a second call, and lstm_sequence_backward's
     device kernels per call counted by torch.profiler (at most two, none
     from a library);
  4. the ICU LSTM models (depth 1, and depth 2, which passes a hidden
     sequence between layers), their logits and their gradients (every
     parameter's .grad through the backward kernel), and zamba2 and
     xlstm-350m at full width with one group, on the card (kernel path)
     against the same models on the CPU (plain path), logits and (on
     noised parameters) gradients; then, on noised
     parameters, gemma2-27b (local
     + global, window cut to 64, 8 decode steps through the ring buffer,
     also held to teacher forcing), qwen2-1.5b with the int8 KV cache,
     one mixtral-8x7b MoE layer (router flips reported with their
     margins), llama-3.2-vision-11b's group (4 ATTN + CROSS) and
     seamless-m4t-large-v2 (one encoder and one decoder layer), all at
     full width in float32; the zamba2 and xlstm groups' gradients again
     with `build_model(cfg, remat=True)` (the group recomputed in the
     backward: its forward kernels launched twice) against those without
     remat on the card, and whether they are bit-equal;
  5. the device tabu search on CUDA against the same search on the CPU,
     identical on integer instances: the round regime, the pass regime
     (background-heavy ragged batches with frozen jobs and reservations),
     the device greedy init at 32 wards x 100 jobs, and the
     contention-aware `scheduler.search_fleet` at 8 wards x 40 jobs;
  6. the main paths, each with every launch counter set to 0 just before
     it and read just after:
     a. `repro_torch.launch.serve.run(patients=100)`: calibrate, strategy
        table, lower bound, execution (lstm_sequence, one launch per ICU
        inference and layer; no lstm_cell step); then the paper's pipeline,
        `repro_torch.examples.serve_hierarchical` with its defaults (the
        offline phase, then 12 patients; lstm_sequence forward and
        backward);
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
     f. the rest of the LLM zoo, each `ServingEngine(build_model(cfg),
        device="cuda").generate(make_batch(cfg, 4, 512), steps=32)` at
        full width in bf16 with random weights drawn on the card (the
        earlier engines freed first): gemma2-27b at full depth (46 flash
        launches per prefill), then on one prompt of 4608 tokens (the
        window bites, decode wraps the 4096-slot ring); gemma-2b;
        qwen2-1.5b native and with the int8 KV cache; mixtral-8x7b at 8
        of its 32 layers (full depth does not fit one card);
        llama-3.2-vision-11b; seamless-m4t-large-v2 (flash_attention);
     g. training (`drive_training`): the paper's offline phase (3 ICU
        models x 60 AdamW steps) on the card and on the host CPU from the
        same weights (lstm_sequence forward and backward); qwen2-1.5b at
        full width and depth in bf16 through `repro_torch.launch.train`,
        5 steps at 8 x 1024 tokens (28 flash forward and 28 backward
        launches a step), one more step timed in parts and one traced;
        the gradients of one qwen2 group and of reduced gemma2 against
        the CPU; zamba2-2.7b (4 x 1024 tokens) and xlstm-350m (8 x 1024)
        at full width and depth in bf16 through `launch.train`, 3 steps
        each (45 + 45 ssm_scan and 9 + 9 flash launches a zamba2 step, 21
        + 21 mlstm_chunk launches an xlstm step), step 0's batch scoring
        lower after the last step than under the initial weights, one
        more step of each traced;
     h. zamba2-2.7b's loss and gradients on 6g's weights at 4 x 1024,
        built with and without remat: time (CUDA events, median of 3),
        peak memory (the remat peak must be lower), launches (with remat
        90 ssm_scan and 18 flash forwards, 45 and 9 backwards) and equal
        losses; then the longest length that fits at batch 4 for each
        setting (2048 ... 8192, and 16384 with remat), each ladder ending
        at its first out-of-memory error;
  7. timings with CUDA events (and by CUDA-graph replay, the device time
     alone, for each kernel at its main-path shape), each printed beside
     the card's name and power limit (flash_attention also at each of
     phase 6f's prefill shapes, beside scaled_dot_product_attention
     where it computes the same function), and for ssm_scan, mlstm_chunk,
     their backwards and the bf16 flash kernels the registers and spills
     `nvcc -Xptxas -v` reported and the tensor-core (HMMA, HGMMA) and
     TMA-load (UTMALDG) instructions in each kernel's SASS (the flash
     kernels held to wgmma and TMA, unserialized, no spills up to
     D = 128; the scans' bf16 backward kernels that carry products to
     tensor-core instructions), and the host time of
     encoding a tensor map; the
     schedule searches on CUDA, on the host CPU and in Python (host clock
     after a synchronise), and the device search's kernel launches per
     pass-regime sweep (torch.profiler); the metro engine's events/s on
     CUDA and on the host CPU (phase 6e's runs); the backward kernels at
     the training paths' shapes (lstm_sequence_backward also by CUDA-graph
     replay, in the offline phase's call too, with its device kernels per
     call and `serial_bwd_estimate`) beside cuDNN's nn.LSTM backward and
     scaled_dot_product_attention's backward, and the scans' backward
     kernels at zamba2's and xlstm's training shapes beside their bounds;
  8. one more run of each main path under torch.profiler (metro: the
     tabu run of mass_casualty_crash; the LLM paths zamba2-2.7b,
     xlstm-350m and gemma2-27b, traced while their engines are up; one
     training step of qwen2-1.5b, zamba2-2.7b and xlstm-350m):
     device busy share and the kernels that take the device's time.
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
# the bf16 kernels' tensor-map edges: D = 80 and 256 (two and four
# 64-column boxes, the last zero-filled past D) with L not a multiple of
# 64 or 128, a single query, D = 36 (rows TMA cannot take: the staging
# path), window 0 (no live key: zeros, +inf log-sum-exp)
HOPPER_ATTN = [(2, 8, 2, 200, 333, 80, True, None, None),
               (1, 4, 1, 70, 150, 256, True, 100, 50.0),
               (3, 4, 4, 1, 77, 80, False, None, None),
               (1, 4, 2, 90, 130, 36, True, None, None),
               (2, 4, 2, 96, 96, 64, True, 0, None)]
# and q, k, v as contiguous views into larger buffers, their bases
# offset by these many elements: 8 (16 bytes) keeps TMA's 16-byte rule,
# 3 fails it and takes the staging path
VIEW_OFFSETS = (8, 3)
VIEW_ATTN = (2, 8, 4, 200, 200, 128, True, None, None)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 flash, besides ATTN_TOL: every output row (one query's D values)
# within this relative L2 distance of the plain row. The kernel's two bf16
# roundings (P before P.V, the output) give a few 2^-9; with N(0, 1) inputs
# a row's output shrinks as sqrt(e / live keys), so at 4096 keys ATTN_TOL's
# atol is the size of a value, while one skipped 64-key tile moves a row
# by about sqrt(64 / live keys), over 0.1 at every shape here
FLASH_BF16_ROW_REL = 1e-2
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
# phase 6f, the rest of the LLM zoo at full width, bf16: (config, changes,
# flash_attention launches per prefill). mixtral-8x7b's 32 layers take
# ~93 GB of bf16 and do not fit one card: depth cut to 8 of 32 (~23.8 GB)
LLM_PATHS = [
    ("gemma2-27b", {}, 46),
    ("gemma-2b", {}, 18),
    ("qwen2-1.5b", {}, 28),
    ("qwen2-1.5b", {"kv_cache_dtype": "int8"}, 28),
    ("mixtral-8x7b", {"num_layers": 8, "num_groups": 8}, 8),
    ("llama-3.2-vision-11b", {}, 40),         # 32 self + 8 cross
    ("seamless-m4t-large-v2", {}, 72),        # 24 encoder, 24 self, 24 cross
]
# gemma2-27b on one prompt longer than its 4096-token window: the window
# bites in the local layers' prefill and decode wraps their ring buffer
LONG_PROMPT = 4608
# flash_attention at the shapes phase 6f's prefills give it (b, hq, hkv,
# lq, lk, d, causal, window, softcap), and its launches per prefill there
LLM_ATTN = {
    "gemma2-27b local": ((4, 32, 16, 512, 512, 128, True, 4096, 50.0), 23),
    "gemma2-27b global": ((4, 32, 16, 512, 512, 128, True, None, 50.0), 23),
    "gemma2-27b local 4608": ((1, 32, 16, LONG_PROMPT, LONG_PROMPT, 128,
                               True, 4096, 50.0), 23),
    "gemma2-27b global 4608": ((1, 32, 16, LONG_PROMPT, LONG_PROMPT, 128,
                                True, None, 50.0), 23),
    "gemma-2b": ((4, 8, 1, 512, 512, 256, True, None, None), 18),
    "qwen2-1.5b": ((4, 12, 2, 512, 512, 128, True, None, None), 28),
    "mixtral-8x7b": ((4, 32, 8, 512, 512, 128, True, 4096, None), 8),
    "llama-vision self": ((4, 32, 8, 512, 512, 128, True, None, None), 32),
    "llama-vision cross": ((4, 32, 8, 512, 4096, 128, False, None, None), 8),
    "seamless encoder": ((4, 16, 16, 1024, 1024, 64, False, None, None), 24),
    "seamless self": ((4, 16, 16, 512, 512, 64, True, None, None), 24),
    "seamless cross": ((4, 16, 16, 512, 1024, 64, False, None, None), 24),
}
# Lq > Lk (cross attention to fewer states than queries): the Pallas
# kernel's negative query offset; tests/test_torch_attention.py's cases
LQ_GT_LK_ATTN = [(2, 4, 2, 128, 16, 32, False, None, None),
                 (1, 4, 4, 256, 128, 64, False, None, 50.0),
                 (2, 4, 2, 256, 128, 32, True, None, None),
                 (1, 2, 1, 256, 128, 64, True, 64, None),
                 (1, 2, 2, 256, 128, 32, False, 32, None)]
# training (phases 3, 4 and 6g). The backward kernels against their plain
# versions on the same record: lstm_sequence_backward at the ICU shapes at
# the training batch (B = 32, T = 48) and at H = 256, flash_attention_
# backward at ATTN_CASES, LQ_GT_LK_ATTN and TRAIN_ATTN (qwen2-1.5b's
# training shape, GQA 6:1; gemma2's window and softcap; Lq < Lk; rows
# with no live key). Tolerances: float32 1e-4 absolute and relative (sums
# in another order: over 4H per step and T steps, over Lq or Lk); bf16
# gradients are rounded to bf16 on both sides from float32 math, 2e-2, and
# for flash every row within FLASH_BF16_ROW_REL of the plain row, a row's
# norm taken as at least a tenth of the mean row norm (a row whose
# gradient cancels to noise, dq of a query with one live key, has no
# relative error to hold). The training forward's record (gates, cell
# states) at the forward's tolerances.
TRAIN_B = 32
TRAIN_LSTM_SHAPES = [(TRAIN_B, i, h) for (i, h) in ((76, 16), (17, 8),
                                                     (76, 32), (130, 256))]
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
QWEN_TRAIN_ATTN = (8, 12, 2, 1024, 1024, 128, True, None, None)
TRAIN_ATTN = [QWEN_TRAIN_ATTN,
              (2, 32, 16, 512, 512, 128, True, 128, 50.0),
              (1, 4, 2, 200, 700, 64, True, None, None),
              (1, 2, 2, 64, 64, 32, True, 0, None)]
# phase 6g: the paper's offline phase (each ICU workload 60 AdamW steps at
# batch 32, float32) on the card and on the host CPU from the same
# weights, the loss trajectories within ICU_TRAIN_RTOL of each other per
# step (the card's gate math on the special-function unit and float32
# sums in another order, through 60 Adam steps); qwen2-1.5b at full width
# and depth in bf16 through launch.train, TRAIN_STEPS steps at
# TRAIN_BATCH x TRAIN_SEQ; gradients of one group card against CPU on
# noised weights in float32, each leaf within GRAD_ONE_GROUP_TOL of its
# largest entry (float32 sums in another order over d_model 1536)
ICU_TRAIN_STEPS = 60
ICU_TRAIN_RTOL = 1e-5
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 8, 1024
GRAD_ONE_GROUP_TOL = 2e-3
# lstm_cell / lstm_sequence on bf16 inputs (float32 math, h and c in
# bf16): one bf16 rounding of h or c, as the other bf16 kernels' checks
LSTM_BF16_TOL = 2e-2
# the one-group checks of phase 4: seeded noise on every parameter leaf,
# 5% of its std, or std NOISE_ZERO for a leaf at its constant init (norms,
# biases) and NOISE_GATE for a scalar gate (llama-vision's gate_attn), so
# that none sits at its init; the router flips of a float32 order (a
# token's top-2 experts differ between card and CPU) below this margin
NOISE_REL, NOISE_ZERO, NOISE_GATE = 0.05, 0.1, 1.0
ROUTER_FLIP_MARGIN = 1e-5
# config -> (changes, prompt (B, L), decode steps, flash launches per
# prefill); prompts of 512 tokens unless the check needs another
ONE_GROUP_CHECKS = {
    "gemma2-27b": (dict(num_layers=2, num_groups=1, attn_window=64),
                   (2, 128), 8, 2),
    "qwen2-1.5b": (dict(num_layers=1, num_groups=1, kv_cache_dtype="int8"),
                   (1, 512), 4, 1),
    "mixtral-8x7b": (dict(num_layers=1, num_groups=1), (1, 512), 4, 1),
    "llama-3.2-vision-11b": (dict(num_layers=5, num_groups=1), (1, 512), 4,
                             5),
    "seamless-m4t-large-v2": (dict(num_layers=1, num_groups=1,
                                   encoder_layers=1), (1, 512), 4, 3),
}
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
# the scans' backward kernels (phase 3) against their plain versions,
# float32 and bf16 under GRAD_TOL (bf16: and the row bar), with cotangents
# on y and on the final state: ragged shapes (P, D not multiples of a
# block's rows; L of a segment or chunk; L < 64) and the training shapes
# of phase 6g, zamba2-2.7b's (b, l, h, p, n) at 4 x 1024 and
# xlstm-350m's (b, l, h, d) at 8 x 1024
SSM_TRAIN = (4, 1024, 80, 64, 64)
MLSTM_TRAIN = (8, 1024, 4, 512)
GRAD_NAMES = {"ssm_scan_backward": ("dx", "ddt", "da", "db", "dc", "dd"),
              "mlstm_chunk_backward": ("dq", "dk", "dv", "di", "df")}
SSM_GRAD_CASES = [(2, 37, 3, 24, 20), (1, 70, 5, 80, 128), SSM_TRAIN]
# phase 7: the scans' backward sources, the bf16 kernels that carry their
# products (each must hold tensor-core instructions) and the others
SCAN_BWD_KERNELS = (
    ("ssm_scan_bwd", ("ssd_bwd_states_kernel", "ssd_bwd_main_kernel"),
     ("ssd_bwd_pass_kernel", "ssd_bwd_reduce_kernel", "ssm_bwd_kernel",
      "ssm_bwd_reduce_kernel")),
    ("mlstm_chunk_bwd", ("mlstm_bwd_forward_tc_kernel",
                         "mlstm_bwd_reverse_tc_kernel",
                         "mlstm_bwd_chunks_tc_kernel"),
     ("mlstm_bwd_gates_kernel", "mlstm_bwd_steps_kernel",
      "mlstm_bwd_chain_kernel", "mlstm_bwd_forward_kernel",
      "mlstm_bwd_reverse_kernel", "mlstm_bwd_chunks_kernel")))
MLSTM_GRAD_CASES = [(1, 40, 3, 80), (2, 300, 4, 512), MLSTM_TRAIN]
# phase 6g: zamba2-2.7b and xlstm-350m at full width and depth in bf16
# through launch.train, SCAN_TRAIN_STEPS steps at (batch, seq) each;
# their launches per step: ssm_scan forward and backward per Mamba2 block
# (45), flash forward and backward per shared-attention application (9);
# mlstm_chunk forward and backward per mLSTM block (21)
SCAN_TRAIN = {"zamba2-2.7b": (4, 1024), "xlstm-350m": (8, 1024)}
SCAN_TRAIN_STEPS = 3
# phase 6h: zamba2-2.7b's loss and gradients on phase 6g's trained weights
# at REMAT_BATCH x REMAT_SEQ, built with and without remat (each group
# recomputed in the backward: its forward kernels launched twice), timed
# REMAT_REPS times by CUDA events (median); then at batch REMAT_BATCH the
# ladder of lengths, each setting up to its first out-of-memory error
REMAT_BATCH, REMAT_SEQ, REMAT_REPS = 4, 1024, 3
REMAT_LADDER = {False: (2048, 4096, 8192), True: (2048, 4096, 8192, 16384)}
# phase 6a's neighbour: the paper's pipeline, examples/serve_hierarchical
# on the port (the offline phase, 60 steps per ICU workload, then
# serve.run on its default 12 patients)
HIER_PATIENTS = 12
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


def sequence_bwd_bound(shape, t_len):
    """Least time (ms) of one lstm_sequence_backward call (one layer, T
    steps, float32), as its two parts: xs, the weights, the recorded hs,
    gates and cell states and the upstream gradients (h_T, c_T, the
    sequence) read once and dxs and the weights' gradients written once
    over the HBM rate; and the operations over the float32 rate: per step
    the chain's dh . wh^T (8 B H H) and ~20 pointwise operations per
    unit, then dxs, dwx (8 T B H I each), dwh (8 T B H H) and db."""
    b, i, h = shape
    t = t_len
    nbytes = 4 * (t * b * i + 4 * h * (i + h) + t * b * h + t * b * 4 * h
                  + t * b * h + 2 * b * h + t * b * h
                  + t * b * i + 4 * h * (i + h) + 4 * h)
    ops = t * (8 * b * h * h + 20 * b * h) + 16 * t * b * h * i \
        + 8 * t * b * h * h + 4 * t * b * h
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def flash_bwd_bound(case):
    """Least time (ms) of one flash_attention_backward call in bf16, as
    its two parts: q, k, v, O, dO (bf16) and the row log-sum-exp (f32)
    read once and dq, dk, dv (bf16) written once over the HBM rate; and
    2.5 times the forward's products over the live pairs (S recomputed,
    dP, dV, dQ, dK: five products of 2 D FLOPs per live pair against the
    forward's two) at the bf16 tensor-core rate."""
    b, hq, hkv, lq = case[:4]
    by_bytes, fwd_ops = flash_bound(case, 2, BF16_FLOPS)
    d = case[5]
    # besides the forward's q, k, v, O: dO read, dq, dk, dv written
    extra = 2 * d * (2 * b * hq * lq + 2 * b * hkv * case[4]) \
        + 4 * b * hq * lq
    return by_bytes + extra / HBM_BYTES_PER_S * 1e3, 2.5 * fwd_ops


def serial_bwd_estimate(shape, t_len):
    """An estimate (ms), not a bound, of lstm_sequence_backward's T
    dependent steps alone: per step the chain's 4H FMAs of dh_next (4
    cycles each, in one dependent sum) and the gate math's two dependent
    special-function operations (tanh's exp2 and reciprocal, ~20 cycles
    each), at the boost clock."""
    h = shape[2]
    return t_len * (4 * 4 * h + 2 * 20) / SM_CLOCK_HZ * 1e3


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


def view_inputs(torch, tensors, offset):
    """Copies of `tensors` as contiguous views into larger buffers, each
    starting `offset` elements in."""
    out = []
    for t in tensors:
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        out.append(view)
    return out


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


def ssm_bwd_bound(shape, itemsize, flops_per_s):
    """Least time (ms) of one ssm_scan_backward call with no cotangent on
    the final state, as its two parts: x, b, c, dy (itemsize bytes), dt,
    a and d (f32) read once and dx, db, dc (itemsize) and ddt, da, dd
    (f32) written once over the HBM rate; and the reverse scan's
    arithmetic over the peak rate for the inputs' type, per state element
    and step: h recomputed (3 FLOPs), dh += dy C (2), the four sums dy h,
    u dh, dh B, dh h (8), dh x B (3), dh *= e (1): 17; per output element
    of dx, D dy + dt (.) (3)."""
    b, l, h, p, n = shape
    nbytes = (itemsize * (3 * b * l * h * p + 4 * b * l * n)
              + 4 * (2 * b * l * h + 4 * h))
    ops = 17 * b * l * h * p * n + 3 * b * l * h * p
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / flops_per_s * 1e3


def mlstm_bwd_bound(shape, itemsize, flops_per_s):
    """Least time (ms) of one mlstm_chunk_backward call with no cotangent
    on the final state, as its two parts: q, k, v, dy (itemsize bytes)
    and the f32 gates read once and dq, dk, dv (itemsize) and di, df (f32)
    written once over the HBM rate; and 2.5 x the forward's products
    (mlstm_bound) over the peak rate for the inputs' type, as
    flash_bwd_bound counts a backward."""
    b, l, h, d = shape
    nbytes = itemsize * 7 * b * l * h * d + 4 * 4 * b * l * h
    fwd_ops_ms = mlstm_bound(shape, itemsize, flops_per_s)[1]
    return nbytes / HBM_BYTES_PER_S * 1e3, 2.5 * fwd_ops_ms


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def noised(torch, tree, seed):
    """Add seeded noise to every floating leaf of `tree` in place, drawn
    on each leaf's device: NOISE_REL of the leaf's std, or std NOISE_ZERO
    for a leaf that is all zeros (norms, biases) and NOISE_GATE for a
    scalar (a gate). Returns the tree."""
    gens = {}
    for t in leaves(tree):
        if not t.is_floating_point():
            continue
        if t.device not in gens:
            gens[t.device] = torch.Generator(t.device).manual_seed(seed)
        if t.dim() == 0:
            std = NOISE_GATE
        elif not bool(t.any()):
            std = NOISE_ZERO
        else:
            std = NOISE_REL * float(t.float().std())
        t.add_((torch.randn(t.shape, generator=gens[t.device],
                            device=t.device) * std).to(t.dtype))
    return tree


def one_group_card_vs_cpu(torch, model, p_gpu, prompt, kernels, label, *,
                          extra=None, follow=None, steps=4, teacher=False):
    """Prefill `prompt` (with the `extra` batch keys, vision embeddings or
    frames) and `steps` decode steps with `model` on the card from `p_gpu`
    and on the CPU from a copy; raises unless every step's logits agree
    within ONE_GROUP_TOL. Decode feeds `follow` (B, steps) when given,
    else the CPU's greedy tokens. With `teacher`, the card's prefill and
    decode logits are also held to its own full-sequence forward over the
    prompt and `follow` (teacher forcing). Returns the largest error in
    prefill and in decode (and against teacher forcing, or None), and the
    launches of each of `kernels` in prefill and in decode."""
    cuda = torch.device("cuda")
    p_cpu = tree_to(p_gpu, "cpu")
    plen = prompt.shape[1]
    extra = extra or {}
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

    def batch(tokens, device):
        return {"tokens": tokens.to(device),
                **{k: v.to(device) for k, v in extra.items()}}

    gpu_logits = []
    with torch.inference_mode():
        snap()
        lg, cg = model.prefill(p_gpu, batch(prompt, cuda),
                               max_len=plen + steps)
        torch.cuda.synchronize()
        snap()
        lc, cc = model.prefill(p_cpu, batch(prompt, "cpu"),
                               max_len=plen + steps)
        compare(lg, lc, "prefill")
        gpu_logits.append(lg)
        tok = follow[:, 0] if follow is not None else lc.argmax(-1)
        for step in range(steps):
            lg, cg = model.decode_step(p_gpu, tok.to(cuda), cg)
            lc, cc = model.decode_step(p_cpu, tok, cc)
            compare(lg, lc, f"decode step {step}")
            gpu_logits.append(lg)
            if follow is not None and step + 1 < steps:
                tok = follow[:, step + 1]
            else:
                tok = lc.argmax(-1)
        torch.cuda.synchronize()
        snap()
        tf_err = None
        if teacher:
            # the forward's logits at positions plen - 1 .. plen + steps - 1
            # predict what prefill and the decode steps predict
            tokens = torch.cat([prompt, follow[:, :steps]], dim=1)
            full, _ = model.forward(p_gpu, batch(tokens, cuda))
            want = full[:, plen - 1:]
            got = torch.stack(gpu_logits, dim=1)
            tf_err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=ONE_GROUP_TOL,
                                  rtol=ONE_GROUP_TOL):
                raise RuntimeError(f"{label}: prefill + decode and teacher "
                                   f"forcing differ by {tf_err}")
    pre = tuple(b - a for a, b in zip(counts[0], counts[1]))
    dec = tuple(b - a for a, b in zip(counts[1], counts[2]))
    return errs[0], max(errs[1:]), tf_err, pre, dec


def check_llm_one_group(torch, flash_attention, name):
    """One of phase 4's checks of the LLM zoo (ONE_GROUP_CHECKS) at full
    width with one group (or one layer), float32, card against CPU on the
    same noised parameters (`noised`), at ONE_GROUP_TOL: gemma2-27b (local
    + global) with its window cut to 64 so that it bites at 2 x 128
    tokens, and 8 decode steps through the ring buffer, also held to
    teacher forcing; qwen2-1.5b with the int8 KV cache; one mixtral-8x7b
    MoE layer, with any token whose top-2 experts differ between card and
    CPU reported beside its router margin; llama-3.2-vision-11b's group
    (4 ATTN + CROSS); seamless-m4t-large-v2 with one encoder and one
    decoder layer."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import blocks, build_model
    cuda = torch.device("cuda")
    k = list(ONE_GROUP_CHECKS).index(name)
    change, shape, steps, flash_pre = ONE_GROUP_CHECKS[name]
    cfg = dataclasses.replace(get_config(name), dtype="float32", **change)
    model = build_model(cfg)
    p_gpu = noised(torch, model.init(torch.Generator(cuda).manual_seed(
        20 + k), device=cuda), seed=30 + k)
    batch = make_batch(cfg, shape[0], shape[1], seed=40 + k)
    prompt = batch.pop("tokens")
    teacher = name == "gemma2-27b"
    follow = torch.randint(0, cfg.vocab_size, (shape[0], steps),
                           generator=torch.Generator().manual_seed(k))
    moe_inputs, moe_ffn = [], blocks._moe_ffn
    if cfg.num_experts:
        def spy(p, x, cfg_):
            if len(moe_inputs) < 2:             # the two prefills' inputs
                moe_inputs.append((p, x))
            return moe_ffn(p, x, cfg_)
        blocks._moe_ffn = spy
    try:
        e_pre, e_dec, e_tf, pre, dec = one_group_card_vs_cpu(
            torch, model, p_gpu, prompt, (flash_attention,),
            f"{name} one group", extra=batch,
            follow=follow if teacher else None, steps=steps,
            teacher=teacher)
    finally:
        blocks._moe_ffn = moe_ffn
    tf = "" if e_tf is None else f", teacher forcing {e_tf:.3e}"
    print(f"{name} full width, {cfg.num_layers} layer(s)"
          f"{', encoder 1' if cfg.is_encdec else ''}, float32, noised, "
          f"prompt {tuple(prompt.shape)}: max |cuda - cpu| logits prefill "
          f"{e_pre:.3e}, {steps} decode steps {e_dec:.3e}{tf} (atol = rtol "
          f"= {ONE_GROUP_TOL}); flash launches prefill {pre[0]}, decode "
          f"{dec[0]}")
    if pre != (flash_pre,) or dec != (0,):
        raise RuntimeError(f"{name} one group: flash launches prefill "
                           f"{pre}, decode {dec}; expected {flash_pre} and 0")
    if moe_inputs:
        (pg, xg), (pc, xc) = moe_inputs
        top_g, _ = router_top2(torch, blocks, cfg, pg, xg)
        top_c, margin = router_top2(torch, blocks, cfg, pc, xc)
        flips = (top_g != top_c).any(dim=-1).nonzero().flatten()
        print(f"{name} router: {len(flips)} of {len(top_c)} tokens with "
              f"other top-2 experts on the card than on the CPU"
              + "".join(f"; token {int(t)}: card {top_g[t].tolist()}, cpu "
                        f"{top_c[t].tolist()}, margin {float(margin[t]):.3e}"
                        for t in flips)
              + f"; smallest margin {float(margin.min()):.3e}")
        if any(float(margin[t]) >= ROUTER_FLIP_MARGIN for t in flips):
            raise RuntimeError(f"{name}: a top-2 flip at a router margin "
                               f">= {ROUTER_FLIP_MARGIN}")
    del p_gpu, moe_inputs
    torch.cuda.empty_cache()


def router_top2(torch, blocks, cfg, p, x):
    """Each token's top-2 experts (a sorted pair) and its router margin
    (the 2nd largest probability less the 3rd) for MoE block parameters
    `p` and the block's input x (B, S, d), as `blocks._moe_ffn` routes
    them."""
    from repro_torch.models import common
    h = common.rms_norm(x, p["moe_norm"], cfg.norm_eps)
    probs = torch.softmax(h.to(torch.float32) @ p["router"], dim=-1)
    w, idx = blocks._top_k(probs, 3)
    top2 = torch.sort(idx[..., :2], dim=-1).values.reshape(-1, 2)
    return top2.cpu(), (w[..., 1] - w[..., 2]).reshape(-1).cpu()


def trace_generate(torch, engine, batch, label, card):
    """The serving path traced twice under torch.profiler: prefill alone
    (steps=1), then prefill and 7 decode steps; the difference, over 7,
    is what one decode step costs."""
    from torch.profiler import ProfilerActivity, profile
    traced = {}
    for steps in (1, 8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def drive_generate(torch, cfg, kernels, per_prefill, card, *, batch=None,
                   engine=None, label=None):
    """The serving path of `cfg` at full width and depth:
    `ServingEngine(build_model(cfg), device="cuda").generate(batch,
    steps=32)` with random weights drawn on the card (or `engine`'s), the
    batch `make_batch(cfg, 4, 512)` unless given, every counter of
    `kernels` (name -> wrapper) set to 0 just before and read just after.
    Raises unless the run launched `per_prefill` (one prefill), the tokens
    extend the prompt within the vocab, a second greedy run gives the
    same tokens, and one more prefill and decode step launch
    `per_prefill` and nothing and give finite logits of the padded
    vocab's shape with the padding masked. Returns (engine, batch, the
    launches of the first run, the prefill's cache of that last check)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model
    from repro_torch.models.decoder import padded_vocab
    from repro_torch.serving.engine import ServingEngine
    cuda = torch.device("cuda")
    label = label or cfg.name

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    held = torch.cuda.memory_allocated()   # by earlier phases
    if engine is None:
        t0 = time.perf_counter()
        engine = ServingEngine(build_model(cfg), device=cuda)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in leaves(engine.params))
        print(f"{label}: {n_params / 1e9:.3f} B parameters ({cfg.dtype}) "
              f"drawn on the card in {init_s:.2f} s")
    if batch is None:
        batch = make_batch(cfg, GEN_BATCH, GEN_PROMPT, seed=0)
    bsz, plen = batch["tokens"].shape
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    gen = engine.generate(batch, steps=GEN_STEPS)
    launched = counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    toks = gen.tokens
    print(f"{label}: generate({tuple(batch['tokens'].shape)}, "
          f"steps={GEN_STEPS}) -> tokens {tuple(toks.shape)}; launches "
          f"{launched}")
    want_shape = (bsz, plen + GEN_STEPS)
    if tuple(toks.shape) != want_shape or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size or not torch.equal(
                toks[:, :plen].cpu(), batch["tokens"]):
        raise RuntimeError(f"{label} generate: bad tokens "
                           f"{tuple(toks.shape)}")
    if launched != per_prefill:
        raise RuntimeError(f"{label} generate: launches {launched}, "
                           f"expected {per_prefill}")
    gen2 = engine.generate(batch, steps=GEN_STEPS)
    if not torch.equal(gen2.tokens, toks):
        raise RuntimeError(f"{label} generate: a second greedy run "
                           f"returned other tokens")
    dtype = getattr(torch, cfg.dtype)
    dev_batch = {k: v.to(cuda, dtype) if v.is_floating_point()
                 else v.to(cuda) for k, v in batch.items()}
    with torch.inference_mode():
        c0 = counts()
        lg, cache = engine.model.prefill(engine.params, dev_batch,
                                         max_len=plen + 1)
        c1 = counts()
        lg2, _ = engine.model.decode_step(engine.params, lg.argmax(-1),
                                          cache)
        c2 = counts()
    pre = {name: c1[name] - c0[name] for name in kernels}
    dec = {name: c2[name] - c1[name] for name in kernels}
    print(f"{label}: launches per prefill {pre}, per decode step {dec}")
    if pre != per_prefill or any(dec.values()):
        raise RuntimeError(f"{label}: launches per prefill {pre}, per "
                           f"decode step {dec}")
    vpad = padded_vocab(cfg.vocab_size)
    for what, logits in (("prefill", lg), ("decode", lg2)):
        pad = logits[:, cfg.vocab_size:]
        if tuple(logits.shape) != (bsz, vpad) or \
                not bool(torch.isfinite(logits).all()) or \
                (pad.numel() and float(pad.max()) > -1e29):
            raise RuntimeError(f"{label} {what} logits: shape "
                               f"{tuple(logits.shape)}, not finite or the "
                               f"vocab padding not masked")
    for run, g in (("run 1", gen), ("run 2", gen2)):
        print(f"[{card}] {label} generate {run}: prefill "
              f"{g.prefill_seconds:.4f} s, decode "
              f"{g.decode_seconds / (GEN_STEPS - 1) * 1e3:.3f} ms per "
              f"step ({GEN_STEPS - 1} steps, {g.decode_seconds:.3f} s)")
    print(f"[{card}] {label} generate: peak device memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated less the "
          f"{held / 1e9:.2f} GB held before the run)")
    return engine, batch, launched, cache


def drive_llm_zoo(torch, kernels, card):
    """Phase 6f: each of LLM_PATHS through `drive_generate` at full width
    in bf16, and gemma2-27b once more on one prompt of LONG_PROMPT tokens
    (the window bites in prefill, decode wraps the local layers' ring of
    attn_window slots); gemma2-27b's 4 x 512 path is also traced (phase
    8's `trace_generate`) while its engine is up. Each engine is freed
    before the next is drawn. Returns {label: flash launches of its first
    run}."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    launches = {}
    for name, change, flash in LLM_PATHS:
        cfg = dataclasses.replace(get_config(name), **change)
        label = name + "".join(f" {k}={v}" for k, v in change.items()
                               if k != "num_groups")
        want = {k: 0 for k in kernels}
        want["flash_attention"] = flash
        engine, batch, launched, cache = drive_generate(
            torch, cfg, kernels, want, card, label=label)
        launches[label] = launched["flash_attention"]
        del cache
        if name == "gemma2-27b":
            trace_generate(torch, engine, batch, label, card)
            long_batch = make_batch(cfg, 1, LONG_PROMPT, seed=3)
            _, _, launched, cache = drive_generate(
                torch, cfg, kernels, want, card, batch=long_batch,
                engine=engine, label=f"{name} 1 x {LONG_PROMPT}")
            slots = cache["groups"][0]["b0_attn_local"]["attn"]["k"].shape[2]
            print(f"{name} 1 x {LONG_PROMPT}: local layers' ring buffer "
                  f"{slots} slots (window {cfg.attn_window})")
            if slots != cfg.attn_window:
                raise RuntimeError(f"{name}: local cache of {slots} slots")
            launches[f"{name} 1 x {LONG_PROMPT}"] = \
                launched["flash_attention"]
            del cache
        del engine, batch
        gc.collect()
        torch.cuda.empty_cache()
    return launches


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
    tensor-core instructions in its SASS (`cuobjdump -sass` of the built
    library): HMMA (`mma.sync`), HGMMA (`wgmma`), and the TMA loads
    (UTMALDG); and whether ptxas serialized its wgmmas (a "Potential
    Performance Loss" note naming it). Returns [(line, label, spill bytes,
    {instruction: count, "serialized": 0 or 1})]."""
    import re
    info, cur = {}, None
    log = build.log_path(name).read_text()
    serialized = set(re.findall(r"wgmma\.mma_async instructions are serialized"
                                r".*?function '(\S+)'", log))
    for line in log.splitlines():
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
    counts = {}
    for part in sass.split("Function : ")[1:]:
        counts[part.split()[0]] = {
            op: len(re.findall(rf"\b{op}\b", part))
            for op in ("HMMA", "HGMMA", "UTMALDG")}
    lines = []
    for mangled, props in info.items():
        label = next((k for k in kernels if k in mangled), None)
        if label is None:
            continue
        args = mangled.split(label, 1)[1]
        ints = re.findall(r"Li(\d+)E", args.split("Ev", 1)[0]) \
            if args.startswith("I") else []
        label += f"<{', '.join(ints)}>" if ints else ""
        label += " (row lse)" if "Lb1E" in mangled else ""
        n = dict(counts.get(mangled, {}), serialized=int(mangled in serialized))
        spills = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", " ".join(props)))
        lines.append((f"{name}.cu {label}: {'; '.join(props)}; "
                      + ", ".join(f"{n.get(op, 0)} {op}"
                                  for op in ("HMMA", "HGMMA", "UTMALDG"))
                      + " instructions in SASS"
                      + ("; ptxas serialized its wgmmas" if n["serialized"]
                         else ""), label, spills, n))
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
    events (kernels, copies, fills) that take the most of it. The traces
    record device activity alone (ProfilerActivity.CUDA: the device's
    events and the runtime's calls, no host op tree, whose processing
    grows with xlstm's ~274k device events a step); the runtime's calls
    are host-side and left out."""
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
    # device search), the median of 3 runs at n = 100 and one run at n =
    # 1000 (8-20 s each), where the host CPU's torch run (~58 s) is left
    # out to keep the script inside its time limit. n = 1000 runs at B = 1
    # only if B = 32 takes over 60 s on CUDA
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
                if n == large and label == "torch on the host cpu":
                    continue
                batched_s[(n, B, label)] = host_seconds(
                    torch, lambda: scheduler.search_batched(
                        jobs, machines_per_tier=mpt_fleet, **kw), card,
                    f"search_batched B={B} n={n} fleet {FLEET_MPT} {label}",
                    reps=1 if n == large else 3)

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



def grad_close(torch, got, want, dtype_name, *, to_largest=False):
    """Max |got - want| and whether got is within GRAD_TOL of want (bf16:
    and every row within FLASH_BF16_ROW_REL of the plain row, a row's
    norm taken as at least a tenth of the mean row norm). With
    `to_largest`, float32's absolute bar is GRAD_TOL times the gradient's
    largest entry (at least 1): the scans' gradients are float32 sums of
    thousands of terms (P x N per step, H x P heads, D and its column
    blocks), whose rounding scales with the terms, so an entry that
    cancels to near 0 carries the error of its largest terms."""
    g, w = got.float(), want.float()
    tol = GRAD_TOL[dtype_name]
    atol = tol * max(1.0, float(w.abs().max())) \
        if to_largest and dtype_name == "float32" else tol
    ok = got.dtype == want.dtype and torch.allclose(g, w, atol=atol, rtol=tol)
    if dtype_name == "bfloat16" and w.dim() > 1:
        gap, size = (g - w).norm(dim=-1), w.norm(dim=-1)
        floor = 0.1 * size.mean()
        ok = ok and bool((gap <= FLASH_BF16_ROW_REL
                          * torch.clamp(size, min=floor)).all())
    return float((g - w).abs().max()), ok


def device_kernels(torch, fn, calls=20, tries=3):
    """The device kernels `calls` calls of `fn` run, from torch.profiler
    (after a warm-up call): ({kernel name: launches per call}, launches
    per call). The profiler can drop records of a window this short (seen:
    one of a call's two kernels, or none), so a window is `calls` calls,
    and one that recorded nothing is profiled again, up to `tries` times.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CPU:
                # "void (anonymous namespace)::lstm_bwd_..._kernel<...>(...)"
                name = e.key.split("::")[-1].split("(")[0]
                seen[name] = seen.get(name, 0.0) + e.count / calls
        if seen:
            break
    return seen, sum(seen.values())


def fused_lstm_backward(kernels):
    """Whether the device kernels `device_kernels` saw are the fused LSTM
    backward's: at most two launches a call, all of its own kernels, none
    from a library."""
    seen, per_call = kernels
    return 0 < per_call <= 2 and all("lstm_bwd" in n for n in seen) and \
        not any(w in n.lower() for n in seen
                for w in ("gemm", "cublas", "cudnn"))


def check_lstm_backward(torch, cuda):
    """Phase 3: the training forward of lstm_sequence (its record: hs, the
    activated gates, the cell states) and lstm_sequence_backward against
    their plain versions, float32 and bf16, at TRAIN_LSTM_SHAPES and T =
    ICU_T, with upstream gradients on h_T, c_T and the hidden sequence
    (what a layer below a second layer receives): one counted launch, a
    second call bit-equal to the first, a call without dxs giving the same
    weight gradients bit for bit, and the device kernels of one call (the
    profiler): at most two, the fused kernel and the reduction, none from
    a library. Returns the largest float32 gradient error."""
    from repro_torch.kernels.lstm_cell import (
        lstm_sequence_backward, lstm_sequence_backward_plain,
        lstm_sequence_train, lstm_sequence_train_plain)
    worst = 0.0
    for k, shape in enumerate(TRAIN_LSTM_SHAPES):
        b, _, h = shape
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            args = [t.to(dtype) for t in
                    sequence_inputs(torch, shape, ICU_T, cuda, seed=800 + k)]
            g = torch.Generator().manual_seed(900 + k)
            ups = [torch.randn(s_, generator=g).to(cuda, dtype)
                   for s_ in ((b, h), (b, h), (ICU_T, b, h))]
            rec = lstm_sequence_train(*args)
            want = lstm_sequence_train_plain(*args)
            fwd_tol = KERNEL_ATOL if dtype == torch.float32 \
                else LSTM_BF16_TOL
            fwd_err = max(float((a.float() - w.float()).abs().max())
                          for a, w in zip(rec, want))
            call = (args[0], args[1], args[2], *rec[2:], *ups)
            before = lstm_sequence_backward.launches
            grads = lstm_sequence_backward(*call)
            launched = lstm_sequence_backward.launches - before
            again = lstm_sequence_backward(*call)
            no_dxs = lstm_sequence_backward(*call, need_dxs=False)
            plain = lstm_sequence_backward_plain(*call)
            torch.cuda.synchronize()
            errs = [grad_close(torch, a, w, name)
                    for a, w in zip(grads, plain)]
            err = max(e for e, _ in errs)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            same_no_dxs = no_dxs[0] is None and all(
                torch.equal(a, b) for a, b in zip(grads[1:], no_dxs[1:]))
            kernels = device_kernels(torch, lambda: lstm_sequence_backward(
                *call))
            main_kernels = device_kernels(
                torch, lambda: lstm_sequence_backward(*call[:7],
                                                      need_dxs=False))
            print(f"lstm_sequence_backward {shape} T={ICU_T} {name}: "
                  f"training forward's record max |kernel - plain| "
                  f"{fwd_err:.3e} (atol {fwd_tol}); max |kernel - plain| "
                  f"(dxs, dwx, dwh, db) = {err:.3e} (atol = rtol = "
                  f"{GRAD_TOL[name]}); launches {launched}; a second call "
                  f"bit-equal: {same}; without dxs the same weight "
                  f"gradients: {same_no_dxs}; device kernels per call "
                  f"(torch.profiler, 20 calls) {kernels[1]:g}: {kernels[0]}, "
                  f"h_T's gradient alone without dxs {main_kernels[1]:g}")
            if not fwd_err <= fwd_tol or not all(ok for _, ok in errs) or \
                    launched != 1 or not same or not same_no_dxs or \
                    not fused_lstm_backward(kernels) or \
                    not fused_lstm_backward(main_kernels):
                raise RuntimeError(f"lstm_sequence_backward {shape} {name}: "
                                   f"kernel and plain version disagree, two "
                                   f"calls differ, or a call is not the "
                                   f"fused kernels alone")
            if dtype == torch.float32:
                worst = max(worst, err)
    return worst


def check_flash_backward(torch, cuda):
    """Phase 3: the training forward's row log-sum-exp and
    flash_attention_backward against their plain versions, float32 and
    bf16, at ATTN_CASES, LQ_GT_LK_ATTN, TRAIN_ATTN, HOPPER_ATTN's cases
    with D <= 128 and VIEW_ATTN's views; each call made twice, the two
    results bit-equal (no atomics). Returns {(case, view offset, dtype
    name): max gradient error}."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_lse, flash_attention_lse_plain)
    errs = {}
    for k, (case, offset) in enumerate(
            [(c, 0) for c in ATTN_CASES + LQ_GT_LK_ATTN + TRAIN_ATTN
             + [h for h in HOPPER_ATTN if h[5] <= 128]]
            + [(VIEW_ATTN, off) for off in VIEW_OFFSETS]):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q, kk, v = flash_inputs(torch, case, dtype, cuda, seed=1000 + k)
            dout = flash_inputs(torch, case, dtype, cuda, seed=2000 + k)[0]
            if offset:
                q, kk, v, dout = view_inputs(torch, (q, kk, v, dout), offset)
            kw = flash_kwargs(case)
            out, lse = flash_attention_lse(q, kk, v, **kw)
            _, lse_p = flash_attention_lse_plain(q, kk, v, **kw)
            live = torch.isfinite(lse_p)
            lse_err = float((lse[live] - lse_p[live]).abs().max()) \
                if bool(live.any()) else 0.0
            lse_ok = bool((torch.isfinite(lse) == live).all()) and \
                lse_err <= 1e-4
            before = flash_attention_backward.launches
            grads = flash_attention_backward(q, kk, v, out, lse, dout, **kw)
            launched = flash_attention_backward.launches - before
            again = flash_attention_backward(q, kk, v, out, lse, dout, **kw)
            plain = flash_attention_backward_plain(q, kk, v, out, lse, dout,
                                                   **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            res = [grad_close(torch, a, w, name)
                   for a, w in zip(grads, plain)]
            err = max(e for e, _ in res)
            view = f" (views {offset} elements in)" if offset else ""
            print(f"flash_attention_backward {case}{view} {name}: lse max "
                  f"|kernel - plain| {lse_err:.3e} on {int(live.sum())} live "
                  f"rows (atol 1e-4); max |kernel - plain| (dq, dk, dv) = "
                  f"{err:.3e} (atol = rtol = {GRAD_TOL[name]}"
                  + (f", rows {FLASH_BF16_ROW_REL}" if name == "bfloat16"
                     else "") + f"); launches {launched}; a second call "
                  f"bit-equal: {same}")
            if not lse_ok or not all(ok for _, ok in res) or \
                    launched != 1 or not same:
                raise RuntimeError(f"flash_attention_backward {case}{view} "
                                   f"{name}: kernel and plain version "
                                   f"disagree, or two calls differ")
            errs[(case, offset, name)] = err
            del q, kk, v, dout, out, lse, grads, again, plain
    return errs


def check_scan_backward(torch, cuda):
    """Phase 3: ssm_scan_backward and mlstm_chunk_backward against their
    plain versions, float32 and bf16, at SSM_GRAD_CASES and
    MLSTM_GRAD_CASES, with cotangents on y and on the final state, and
    with y's alone (None for the state): one launch per call, and a
    second call bit-equal to the first. Returns {(kernel, case, dtype
    name): max gradient error}."""
    from repro_torch.kernels.mlstm_chunk import (mlstm_chunk_backward,
                                                 mlstm_chunk_backward_plain)
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward,
                                              ssm_scan_backward_plain)
    errs = {}
    for name, kernel, plain, cases, inputs in (
            ("ssm_scan_backward", ssm_scan_backward, ssm_scan_backward_plain,
             SSM_GRAD_CASES, ssm_inputs),
            ("mlstm_chunk_backward", mlstm_chunk_backward,
             mlstm_chunk_backward_plain, MLSTM_GRAD_CASES, mlstm_inputs)):
        for k, case in enumerate(cases):
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                args = inputs(torch, case, dtype, cuda, seed=1300 + k)
                g = torch.Generator().manual_seed(1400 + k)
                if name == "ssm_scan_backward":
                    b, l, h, p, n = case
                    ups = [torch.randn(b, l, h, p, generator=g).to(cuda, dtype),
                           torch.randn(b, h, p, n, generator=g).to(cuda)]
                else:
                    b, l, h, d = case
                    ups = [torch.randn(b, l, h, d, generator=g).to(cuda, dtype),
                           torch.randn(b, h, d, d, generator=g).to(cuda),
                           torch.randn(b, h, d, generator=g).to(cuda),
                           torch.randn(b, h, generator=g).to(cuda)]
                worst, ok, launched, same = 0.0, True, [], True
                # each float32 gradient under the unscaled GRAD_TOL bar
                # too: largest error, largest |plain| entry, entries
                # outside it (over both state variants)
                unscaled, tol = {}, GRAD_TOL["float32"]
                for state in (ups[1:], [None] * len(ups[1:])):
                    before = kernel.launches
                    got = kernel(*args, ups[0], *state)
                    launched.append(kernel.launches - before)
                    again = kernel(*args, ups[0], *state)
                    want = plain(*args, ups[0], *state)
                    torch.cuda.synchronize()
                    same = same and all(torch.equal(a, b)
                                        for a, b in zip(got, again))
                    for gname, a, w in zip(GRAD_NAMES[name], got, want):
                        err, good = grad_close(
                            torch, a, w, str(w.dtype).removeprefix("torch."),
                            to_largest=True)
                        worst, ok = max(worst, err), ok and good
                        if w.dtype == torch.float32:
                            out = int((~torch.isclose(a.float(), w, atol=tol,
                                                      rtol=tol)).sum())
                            e0, m0, n0 = unscaled.get(gname, (0.0, 0.0, 0))
                            unscaled[gname] = (max(e0, err), max(
                                m0, float(w.abs().max())), n0 + out)
                    del got, again, want
                print(f"{name} {case} {dname}: max |kernel - plain| over "
                      f"the gradients {worst:.3e} (rtol = GRAD_TOL of each "
                      f"gradient's dtype, atol the same, in float32 times "
                      f"the gradient's largest entry"
                      + (f", bf16 rows {FLASH_BF16_ROW_REL}"
                         if dname == "bfloat16" else "")
                      + f"), with and without the state's cotangents; "
                      f"launches {launched}; a second call bit-equal: "
                      f"{same}")
                print(f"  {name} {case} {dname}, float32 gradients under "
                      f"the unscaled bar ({tol} abs + rel): "
                      + ", ".join(f"{gn} error {e:.3e}, largest {m:.3e}, "
                                  f"{n} entries outside"
                                  for gn, (e, m, n) in unscaled.items()))
                if not ok or launched != [1, 1] or not same:
                    raise RuntimeError(f"{name} {case} {dname}: kernel and "
                                       f"plain version disagree, or two "
                                       f"calls differ")
                errs[(name, case, dname)] = worst
                del args, ups
    return errs


def check_icu_grads(torch, cuda, kernels):
    """Phase 4: the ICU models (depth 1 and 2) under loss.backward() on
    the card against the CPU on the same weights and batch: every
    parameter's .grad set, finite, non-zero and within MODEL_ATOL, and one
    lstm_sequence_backward launch per layer (the fault this slice repairs:
    on the card the kernels returned tensors autograd could not see, and
    only the head trained)."""
    from repro_torch.configs.icu_lstm import ICU_WORKLOADS
    from repro_torch.data import icu
    from repro_torch.models.lstm import ICULSTM
    bwd = kernels["lstm_sequence_backward"]
    for cfg in [c for base in ICU_WORKLOADS
                for c in (base, dataclasses.replace(base, depth=2))]:
        x, y = icu.generate(cfg, TRAIN_B, seed=5)
        grads, launched = {}, {}
        for d in (cuda, torch.device("cpu")):
            model = ICULSTM(cfg, generator=torch.Generator().manual_seed(7),
                            device=d)
            before = bwd.launches
            model.loss({"features": torch.as_tensor(x, device=d),
                        "labels": torch.as_tensor(y, device=d)}).backward()
            launched[d.type] = bwd.launches - before
            grads[d.type] = {n: p.grad for n, p in model.named_parameters()}
        launched = launched["cuda"]
        bad = [n for n, g in grads["cuda"].items()
               if g is None or not bool(torch.isfinite(g).all())
               or not bool(g.abs().max() > 0)]
        err = max(float((g.cpu() - grads["cpu"][n]).abs().max())
                  for n, g in grads["cuda"].items() if g is not None)
        print(f"ICULSTM {cfg.name} depth {cfg.depth} loss.backward(): "
              f"{len(grads["cuda"])} parameters, without a finite non-zero "
              f".grad: {bad or 'none'}; max |cuda - cpu| grad {err:.3e} "
              f"(atol {MODEL_ATOL}); lstm_sequence_backward launches "
              f"{launched}")
        if bad or not err <= MODEL_ATOL or \
                launched != cfg.depth:
            raise RuntimeError(f"{cfg.name} depth {cfg.depth}: gradients "
                               f"missing or wrong")


def loss_and_grads(torch, kernels, model, params, batch):
    """`model.loss` and the gradient of every leaf of `params` on the
    card: (loss, gradients, {kernel: launches})."""
    ls = list(leaves(params))
    for t in ls:
        t.requires_grad_(True)
    before = {n: k.launches for n, k in kernels.items()}
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, ls)
    torch.cuda.synchronize()
    for t in ls:
        t.requires_grad_(False)
    return (loss.detach(), grads,
            {n: k.launches - before[n] for n, k in kernels.items()})


def grads_card_vs_cpu(torch, model, p_gpu, batch, kernels, label):
    """The gradient of `model.loss` on the card from `p_gpu` (float32)
    and on the CPU from a copy, on `batch`: raises unless every leaf's
    card gradient is finite and non-zero and within GRAD_ONE_GROUP_TOL of
    its largest CPU entry. Returns (max relative error, loss on the card,
    loss on the CPU, {kernel: launches on the card})."""
    cuda = next(leaves(p_gpu)).device
    p_cpu = tree_to(p_gpu, "cpu")
    out = {}
    for dev, p in ((cuda, p_gpu), (torch.device("cpu"), p_cpu)):
        loss, grads, launched = loss_and_grads(
            torch, kernels, model, p, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(loss), grads, launched)
    out["cuda"], out["cpu"] = out[cuda], out[torch.device("cpu")]
    worst, bad = 0.0, 0
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            bad += 1
        scale = max(float(c.abs().max()), 1e-30)
        worst = max(worst, float((g.cpu() - c).abs().max()) / scale)
    n = len(out["cuda"][1])
    print(f"{label}: loss cuda {out['cuda'][0]:.6f}, cpu "
          f"{out['cpu'][0]:.6f}; {n} parameter leaves, {bad} without a "
          f"finite non-zero gradient on the card; max over leaves of "
          f"max |cuda - cpu| / max |cpu| = {worst:.3e} (<= "
          f"{GRAD_ONE_GROUP_TOL}); launches on the card "
          f"{out['cuda'][2]}")
    if bad or not worst <= GRAD_ONE_GROUP_TOL or \
            abs(out["cuda"][0] - out["cpu"][0]) > 1e-3:
        raise RuntimeError(f"{label}: gradients differ or are missing")
    return worst, out["cuda"][0], out["cpu"][0], out["cuda"][2]


def expect_launches(label, got, want):
    """Raise unless a run's launches per kernel are the expected ones."""
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want}")


def step_breakdown(prof):
    """Device self time (ms) of a traced training step by kind: GEMMs
    (cuBLAS's gemm / xmma / nvjet kernels, CUTLASS), flash forward, flash
    backward, the scans' (ssm_scan, mlstm_chunk) forward and backward
    kernels, and the rest (elementwise passes, reductions, copies, the
    optimizer's updates)."""
    from torch.autograd import DeviceType
    kinds = {"gemm": 0.0, "flash forward": 0.0, "flash backward": 0.0,
             "scan forward": 0.0, "scan backward": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        key = e.key.lower()
        kind = ("flash backward" if "flash_bwd" in key
                else "flash forward" if "flash_" in key
                else "scan backward" if "ssm_bwd" in key
                or "ssd_bwd" in key or "mlstm_bwd" in key
                else "scan forward" if "ssm_" in key or "mlstm_" in key
                else "gemm" if any(w in key for w in (
                    "gemm", "xmma", "cutlass", "cublas", "nvjet"))
                else "other")
        kinds[kind] += e.self_device_time_total / 1e3
    return kinds


def check_remat_one_group(torch, kernels, label, cfg, seed, kinds):
    """Phase 4's remat check: one group at full width, float32, noised
    weights (the seeds of the card-against-CPU gradient check), the loss
    and every gradient of `build_model(cfg, remat=True)` against those of
    `build_model(cfg)` on the card, each leaf within GRAD_ONE_GROUP_TOL of
    its largest entry and the losses equal; the leaves bit-equal are
    counted. Launches: each of `kinds`' forward twice under remat (the
    group recomputed in the backward), its backward once."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model
    cuda = torch.device("cuda")
    plain, remat = build_model(cfg), build_model(cfg, remat=True)
    p = noised(torch, plain.init(torch.Generator(cuda).manual_seed(seed),
                                 device=cuda), seed=seed + 10)
    batch = {k: v.to(cuda)
             for k, v in make_batch(cfg, 1, 128, seed=seed).items()}
    loss, grads, launched = loss_and_grads(torch, kernels, plain, p, batch)
    loss_r, grads_r, launched_r = loss_and_grads(torch, kernels, remat, p,
                                                 batch)
    worst, bad, same = 0.0, 0, 0
    for g, r in zip(grads, grads_r):
        if not bool(torch.isfinite(r).all()):
            bad += 1
        worst = max(worst, float((r - g).abs().max())
                    / max(float(g.abs().max()), 1e-30))
        same += bool(torch.equal(r, g))
    n = len(grads)
    print(f"{label} remat gradient, float32, noised, tokens (1, 128): loss "
          f"{float(loss_r):.6f} with remat, {float(loss):.6f} without "
          f"(equal: {bool(torch.equal(loss_r, loss))}); {n} leaves, {same} "
          f"bit-equal to the gradients without remat, {bad} not finite; "
          f"max over leaves of max "
          f"|remat - plain| / max |plain| = {worst:.3e} (<= "
          f"{GRAD_ONE_GROUP_TOL}); launches with remat {launched_r}, "
          f"without {launched}")
    if bad or not worst <= GRAD_ONE_GROUP_TOL or \
            not torch.equal(loss_r, loss):
        raise RuntimeError(f"{label}: remat gradients differ")
    want = {n: 0 for n in kernels}
    for kind, per_group in kinds.items():
        want[kind], want[f"{kind}_backward"] = per_group, per_group
    expect_launches(f"{label} without remat", launched, want)
    want.update({kind: 2 * c for kind, c in kinds.items()})
    expect_launches(f"{label} with remat", launched_r, want)


def drive_remat(torch, kernels, card, cfg, params):
    """Phase 6h: zamba2-2.7b at full width and depth in bf16 on phase 6g's
    trained weights (no optimizer state held), loss and gradients of
    `build_model(cfg)` and `build_model(cfg, remat=True)` on step 0's
    batch at REMAT_BATCH x REMAT_SEQ, every counter set to 0 just before
    each first run and read just after: the peak device memory
    (max_memory_allocated after a reset, less what was held before), the
    launches (remat: each ssm_scan and flash forward twice), the losses
    equal, then REMAT_REPS more runs timed by CUDA events (median). Raises
    unless the remat peak is below the other. Then the ladder of lengths
    at batch REMAT_BATCH (REMAT_LADDER), one run each, each setting until
    its first torch.OutOfMemoryError, caught at that call alone. Returns
    {setting: launches of its first run}."""
    import gc

    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.training import train_loop
    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    out, losses, peaks = {}, {}, {}
    for remat in (False, True):
        model = build_model(cfg, remat=remat)
        batch = next(train.make_batches(cfg, REMAT_BATCH, REMAT_SEQ, 0, cuda))
        gc.collect()
        torch.cuda.empty_cache()
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        loss, grads = train_loop._grads_of(model, params, batch)
        torch.cuda.synchronize()
        out[remat] = {n: k.launches for n, k in kernels.items()}
        peaks[remat] = torch.cuda.max_memory_allocated() - held
        losses[remat] = float(loss)
        del loss, grads
        ms = []
        for _ in range(REMAT_REPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            loss, grads = train_loop._grads_of(model, params, batch)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            del loss, grads
        print(f"[{card}] zamba2-2.7b loss + gradients {REMAT_BATCH} x "
              f"{REMAT_SEQ}, bf16, remat={remat}: "
              f"{statistics.median(ms):.2f} ms (median of {REMAT_REPS}, "
              f"CUDA events: {[round(x, 2) for x in ms]}), peak device "
              f"memory {peaks[remat] / 1e9:.2f} GB (max_memory_allocated "
              f"less the {held / 1e9:.2f} GB held before), loss "
              f"{losses[remat]:.6f}, launches {out[remat]}")
    groups = cfg.num_groups
    mamba = list(cfg.group_pattern).count("mamba") * groups
    want = {n: 0 for n in kernels}
    want.update(ssm_scan=mamba, ssm_scan_backward=mamba,
                flash_attention=groups, flash_attention_backward=groups)
    expect_launches("zamba2-2.7b without remat", out[False], want)
    want.update(ssm_scan=2 * mamba, flash_attention=2 * groups)
    expect_launches("zamba2-2.7b with remat", out[True], want)
    if losses[True] != losses[False]:
        raise RuntimeError(f"zamba2-2.7b: loss {losses[True]} with remat, "
                           f"{losses[False]} without")
    if not peaks[True] < peaks[False]:
        raise RuntimeError(f"zamba2-2.7b: remat peak {peaks[True]} is not "
                           f"below {peaks[False]}")
    print(f"[{card}] zamba2-2.7b remat at {REMAT_BATCH} x {REMAT_SEQ}: peak "
          f"{peaks[True] / 1e9:.2f} GB against {peaks[False] / 1e9:.2f} GB "
          f"({peaks[True] / peaks[False]:.3f}x)")
    for remat, lengths in REMAT_LADDER.items():
        model = build_model(cfg, remat=remat)
        fits = REMAT_SEQ
        for seq in lengths:
            batch = next(train.make_batches(cfg, REMAT_BATCH, seq, 0, cuda))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                loss, grads = train_loop._grads_of(model, params, batch)
                torch.cuda.synchronize()
            except torch.OutOfMemoryError as e:
                print(f"[{card}] zamba2-2.7b ladder remat={remat}: "
                      f"{REMAT_BATCH} x {seq} does not fit "
                      f"({str(e).splitlines()[0][:120]}); end of the ladder")
                break
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - held
            print(f"[{card}] zamba2-2.7b ladder remat={remat}: {REMAT_BATCH}"
                  f" x {seq} fits, loss {float(loss):.4f}, loss + gradients "
                  f"{secs:.3f} s (host clock after a synchronise, first "
                  f"run), peak {peak / 1e9:.2f} GB")
            del loss, grads, batch
            fits = seq
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{card}] zamba2-2.7b ladder remat={remat}: longest length "
              f"that fits at batch {REMAT_BATCH}: {fits} tokens (of "
              f"{(REMAT_SEQ,) + lengths})")
    print(f"phase 6h: {time.perf_counter() - t_phase:.1f} s")
    return out


def drive_serve_hierarchical(torch, kernels, card):
    """Phase 6a's neighbour: `repro_torch.examples.serve_hierarchical`'s
    main on the card with its defaults (the offline phase, 60 steps per
    ICU workload, then serve.run on HIER_PATIENTS patients), every counter
    set to 0 just before and read just after. Raises unless "ours" is
    within the lower bound and every baseline, every job ran, the offline
    losses are finite, and the launches are the offline phase's (one
    lstm_sequence forward and backward a step, one forward per held-out
    scoring) and serving's (one lstm_sequence per inference and layer).
    Returns the launches."""
    import numpy as np

    from repro_torch.configs.icu_lstm import ICU_WORKLOADS
    from repro_torch.examples import serve_hierarchical
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    trained, (results, lb) = serve_hierarchical.main([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {n: k.launches for n, k in kernels.items()}
    ours = results["ours (algorithm 2)"]
    print(f"[{card}] examples.serve_hierarchical on the card: {secs:.3f} s "
          f"(host clock, offline phase and serving), ours weighted "
          f"{ours.weighted_sum:.0f}, lower bound {lb:.0f}, "
          f"{len(ours.entries)} jobs; launches {launched}")
    losses = [x for res in trained.values() for x in res["losses"]]
    if not np.isfinite(losses).all() or len(trained) != len(ICU_WORKLOADS):
        raise RuntimeError("serve_hierarchical: offline phase failed")
    if not ours.weighted_sum >= lb - 1e-9 or \
            len(ours.entries) != HIER_PATIENTS or any(
                ours.weighted_sum > s.weighted_sum + 1e-9
                for s in results.values()):
        raise RuntimeError("serve_hierarchical: ours breaks the bound or "
                           "a baseline, or jobs are missing")
    steps = ICU_TRAIN_STEPS * len(ICU_WORKLOADS)
    depth = ICU_WORKLOADS[0].depth
    expect_launches("serve_hierarchical", launched, dict(
        {n: 0 for n in kernels}, lstm_sequence_backward=steps,
        lstm_sequence=steps + len(ICU_WORKLOADS)
        + (HIER_PATIENTS + 2 * len(ICU_WORKLOADS)) * depth))
    return launched


def drive_training(torch, kernels, card):
    """Phase 6g, the training paths, every counter set to 0 just before
    each run and read just after:
      a. the paper's offline phase (`launch.train.train_offline`, 60 steps
         per ICU workload at batch 32, float32) on the card and on the host
         CPU from the same weights: loss trajectories within
         ICU_TRAIN_RTOL per step, held-out accuracies printed; one
         lstm_sequence and one lstm_sequence_backward launch per step;
      b. qwen2-1.5b at full width and depth, bf16, `launch.train.run`:
         TRAIN_STEPS AdamW steps on MarkovTokenDataset at TRAIN_BATCH x
         TRAIN_SEQ: losses finite and the last below step 0's; 28 flash
         forward and 28 backward launches per step, nothing else; seconds
         per step, tokens/s and peak memory; one more step timed as
         forward + backward and optimizer apart, and one traced
         (torch.profiler): device busy share and where its time goes;
      c. the gradient of one qwen2-1.5b group at full width and of reduced
         gemma2 (window 64 biting at 160 tokens, softcaps), float32 on
         noised weights, card against CPU (`grads_card_vs_cpu`);
      d. zamba2-2.7b (4 x 1024) and xlstm-350m (8 x 1024) at full width
         and depth, bf16, `launch.train.run`, SCAN_TRAIN_STEPS steps each:
         losses finite and the last below step 0's, and step 0's batch
         scoring lower after the last step than under the initial
         weights (eval step, no grad); per step one ssm_scan
         forward and backward launch per Mamba2 block and one flash
         forward and backward per shared-attention application (zamba2),
         one mlstm_chunk forward and backward per mLSTM block (xlstm),
         nothing else; seconds per step, tokens/s, peak memory; one more
         step traced.
    Returns {"icu": launches of a, "qwen2": launches of b, "step_s": ...,
    "scans": {arch: launches, step_s, tokens_s, peak_gb of d}, "zamba2":
    (its config, its trained parameters) for phase 6h}.
    """
    import gc

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.icu_lstm import ICU_WORKLOADS
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.lstm import ICULSTM
    from repro_torch.training import optimizer, train_loop
    cuda = torch.device("cuda")

    def reset():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    # a. the offline phase, card and host CPU from the same weights
    sds = {wl.name: ICULSTM(wl, generator=torch.Generator().manual_seed(0),
                            device="cpu").state_dict()
           for wl in ICU_WORKLOADS}
    reset()
    t0 = time.perf_counter()
    on_card = train.train_offline(ICU_TRAIN_STEPS, device=cuda,
                                  state_dicts=sds)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    icu_launches = counts()
    t0 = time.perf_counter()
    on_cpu = train.train_offline(ICU_TRAIN_STEPS, device="cpu",
                                 state_dicts=sds, log_fn=lambda *_: None)
    cpu_s = time.perf_counter() - t0
    steps = ICU_TRAIN_STEPS * len(ICU_WORKLOADS)
    for name, res in on_card.items():
        a, b = np.asarray(res["losses"]), np.asarray(on_cpu[name]["losses"])
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        print(f"offline phase {name}: loss {a[0]:.4f} -> {a[-1]:.4f} on "
              f"the card, {b[0]:.4f} -> {b[-1]:.4f} on the host CPU; max "
              f"relative gap per step {rel:.3e} (<= {ICU_TRAIN_RTOL}); "
              f"held-out accuracy card {res['accuracy']:.2%}, cpu "
              f"{on_cpu[name]['accuracy']:.2%}")
        if not np.isfinite(a).all() or not rel <= ICU_TRAIN_RTOL:
            raise RuntimeError(f"offline phase {name}: card and CPU "
                               f"trajectories differ")
    print(f"[{card}] offline phase: {steps} steps in {card_s:.3f} s on "
          f"the card ({card_s / steps * 1e3:.3f} ms per step, host clock, "
          f"accuracy passes included), {cpu_s:.3f} s as torch on the host "
          f"CPU; launches {icu_launches}")
    expect_launches("offline phase", icu_launches, dict(
        {n: 0 for n in kernels}, lstm_sequence=steps + len(ICU_WORKLOADS),
        lstm_sequence_backward=steps))

    # b. qwen2-1.5b at full width and depth through launch.train
    reset()
    held = torch.cuda.memory_allocated()
    run = train.run("qwen2-1.5b", steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, device=cuda, log_every=1)
    qwen_launches = counts()
    cfg = run.cfg
    n_params = sum(t.numel() for t in leaves(run.params))
    per_step = {n: c / TRAIN_STEPS for n, c in qwen_launches.items()}
    later = run.step_seconds[1:]
    step_s = statistics.median(later)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"qwen2-1.5b training: {n_params / 1e9:.3f} B parameters (bf16), "
          f"losses {[round(x, 4) for x in run.losses]}; launches "
          f"{qwen_launches} ({per_step['flash_attention']:.0f} flash "
          f"forward and {per_step['flash_attention_backward']:.0f} backward "
          f"per step)")
    print(f"[{card}] qwen2-1.5b training {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"step 0 {run.step_seconds[0]:.3f} s, steps 1-{TRAIN_STEPS - 1} "
          f"{[round(x, 4) for x in later]} s (median {step_s:.4f} s, "
          f"{tokens / step_s:.0f} tokens/s); peak device memory "
          f"{((run.peak_bytes or 0) - held) / 1e9:.2f} GB (max_memory_allocated "
          f"less the {held / 1e9:.2f} GB held before)")
    if not np.isfinite(run.losses).all() or \
            not run.losses[-1] < run.losses[0]:
        raise RuntimeError(f"qwen2-1.5b training: losses {run.losses}")
    expect_launches("qwen2-1.5b training", qwen_launches, dict(
        {n: 0 for n in kernels},
        flash_attention=cfg.num_layers * TRAIN_STEPS,
        flash_attention_backward=cfg.num_layers * TRAIN_STEPS))
    # one more step in two parts (host clock after a synchronise), then
    # one traced
    batch = next(run.batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = train_loop._grads_of(run.model, run.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, opt_state, _ = optimizer.update(
        train.opt_config(3e-4, TRAIN_STEPS), grads, run.opt_state,
        run.params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    print(f"[{card}] qwen2-1.5b one step in parts: loss + gradients "
          f"{t1 - t0:.4f} s, AdamW update {t2 - t1:.4f} s (loss "
          f"{float(loss):.4f})")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, m = run.step_fn(params, opt_state,
                                           next(run.batches))
        float(m["loss"])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    busy_s, _ = print_profile(prof, f"[{card}] traced qwen2-1.5b training "
                              f"step ({TRAIN_BATCH} x {TRAIN_SEQ})",
                              traced_s, 10)
    kinds = step_breakdown(prof)
    print(f"[{card}] traced qwen2-1.5b training step, device time by kind: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
          + f"; host (wall less device busy) "
          f"{(traced_s - busy_s) * 1e3:.2f} ms")
    del run, params, opt_state, batch, loss, m, prof
    gc.collect()
    torch.cuda.empty_cache()

    # c. gradients card vs CPU: one qwen2 group at full width, reduced
    # gemma2 with its window biting, float32, noised weights
    for label, cfg, shape, seed in (
            ("qwen2-1.5b one group", dataclasses.replace(
                get_config("qwen2-1.5b"), num_layers=1, num_groups=1,
                dtype="float32"), (1, 128), 50),
            ("gemma2-27b reduced", get_config("gemma2-27b").reduced(
                layers=2, d_model=128, vocab=256), (2, 160), 51)):
        model = build_model(cfg)
        p_gpu = noised(torch, model.init(torch.Generator(cuda).manual_seed(
            seed), device=cuda), seed=seed + 10)
        batch = make_batch(cfg, *shape, seed=seed)
        _, _, _, launched = grads_card_vs_cpu(
            torch, model, p_gpu, batch, kernels,
            f"{label} gradient, float32, noised, tokens {shape}, window "
            f"{cfg.attn_window}")
        n_attn = cfg.num_layers
        expect_launches(label, launched, dict(
            {n: 0 for n in kernels}, flash_attention=n_attn,
            flash_attention_backward=n_attn))
        del p_gpu
    torch.cuda.empty_cache()

    # d. zamba2-2.7b and xlstm-350m at full width and depth through
    # launch.train, each run's counters read around it alone
    scans = {}
    for name, (batch_n, seq) in SCAN_TRAIN.items():
        gc.collect()
        torch.cuda.empty_cache()
        reset()
        held = torch.cuda.memory_allocated()
        run = train.run(name, steps=SCAN_TRAIN_STEPS, batch=batch_n,
                        seq=seq, device=cuda, log_every=1)
        launched = counts()
        cfg = run.cfg
        n_params = sum(t.numel() for t in leaves(run.params))
        later = run.step_seconds[1:]
        step = statistics.median(later)
        tokens_n = batch_n * seq
        peak = (run.peak_bytes or 0) - held
        print(f"{name} training: {n_params / 1e9:.3f} B parameters (bf16), "
              f"losses {[round(x, 4) for x in run.losses]}; launches "
              f"{launched}")
        print(f"[{card}] {name} training {batch_n} x {seq}: step 0 "
              f"{run.step_seconds[0]:.3f} s, steps 1-{SCAN_TRAIN_STEPS - 1} "
              f"{[round(x, 4) for x in later]} s (median {step:.4f} s, "
              f"{tokens_n / step:.0f} tokens/s); peak device memory "
              f"{peak / 1e9:.2f} GB (max_memory_allocated less the "
              f"{held / 1e9:.2f} GB held before)")
        if not np.isfinite(run.losses).all() or \
                not run.losses[-1] < run.losses[0]:
            raise RuntimeError(f"{name} training: losses {run.losses}")
        pattern = list(cfg.group_pattern)
        per_step = ({"ssm_scan": pattern.count("mamba") * cfg.num_groups,
                     "flash_attention": pattern.count("shared_attn")
                     * cfg.num_groups}
                    if name.startswith("zamba2") else
                    {"mlstm_chunk": pattern.count("mlstm") * cfg.num_groups})
        want = {n: 0 for n in kernels}
        for n, c in per_step.items():
            want[n] = want[f"{n}_backward"] = c * SCAN_TRAIN_STEPS
        expect_launches(f"{name} training", launched, want)
        # the fall judged on one fixed batch, step 0's (the stream drawn
        # again from run's seed 0): its loss under the initial weights
        # (drawn again from seed 0) and after the last step, both by the
        # eval step; counters already read
        first = next(train.make_batches(cfg, batch_n, seq, 0, cuda))
        evaluate = train_loop.make_eval_step(run.model)
        p0 = run.model.init(torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
        fixed = [float(evaluate(p0, first)),
                 float(evaluate(run.params, first))]
        del p0
        print(f"{name} training: step 0's batch, loss {fixed[0]:.4f} under "
              f"the initial weights (step 0 reported {run.losses[0]:.4f}), "
              f"{fixed[1]:.4f} after step {SCAN_TRAIN_STEPS - 1}")
        if not np.isfinite(fixed).all() or not fixed[1] < fixed[0]:
            raise RuntimeError(f"{name} training: step 0's batch, loss "
                               f"{fixed[0]} before and {fixed[1]} after")
        # one more step, traced (phase 8)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            m = run.step_fn(run.params, run.opt_state,
                            next(run.batches))[2]
            float(m["loss"])
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        print_profile(prof, f"[{card}] traced {name} training step "
                      f"({batch_n} x {seq})", traced_s, 10)
        kinds_ms = step_breakdown(prof)
        print(f"[{card}] traced {name} training step, device time by kind: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds_ms.items()))
        scans[name] = {"launches": launched, "step_s": step,
                       "tokens_s": tokens_n / step, "peak_gb": peak / 1e9}
        if name == "zamba2-2.7b":
            zamba2 = (cfg, run.params)          # phase 6h's weights
        del run, m, prof
    gc.collect()
    torch.cuda.empty_cache()
    return {"icu": icu_launches, "qwen2": qwen_launches, "step_s": step_s,
            "tokens_s": tokens / step_s, "scans": scans, "zamba2": zamba2}


def time_backward(torch, cuda, card):
    """Phase 7 for the backward kernels. lstm_sequence_backward at each
    ICU shape at the training batch (B = 32, T = 48, float32, upstream
    gradient on h_T, zeros on c_T and the sequence, dxs computed: the call
    earlier PRs timed): the wrapper (the fused kernel and the reduction) by
    events and by CUDA-graph replay, its plain version and cuDNN's nn.LSTM
    backward (TF32 off) at the same shape; the call a depth-1 ICULSTM's
    loss makes (h_T's gradient alone, the others None, no dxs: the first
    layer's xs are data) by events and graph replay; the device kernels of
    one call (torch.profiler); the bound and `serial_bwd_estimate`.
    flash_attention_backward at qwen2-1.5b's training shape (bf16, causal,
    GQA 6:1): the wrapper (its three or four launches),
    the plain version and SDPA's backward (enable_gqa); the forward with
    and without the row log-sum-exp; and the wrapper at gemma2's window
    and softcap (TRAIN_ATTN[1]). Returns ({shape: times}, flash times)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
        flash_attention_backward_plain, flash_attention_lse)
    from repro_torch.kernels.lstm_cell import (
        lstm_sequence_backward, lstm_sequence_backward_plain,
        lstm_sequence_train)
    per = {}
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for k, shape in enumerate(TRAIN_LSTM_SHAPES[:3]):
        b, i, h = shape
        args = sequence_inputs(torch, shape, ICU_T, cuda, seed=1100 + k)
        rec = lstm_sequence_train(*args)
        ups = (torch.randn(b, h, device=cuda), torch.zeros(b, h,
                                                           device=cuda),
               torch.zeros(ICU_T, b, h, device=cuda))
        bwd_args = (args[0], args[1], args[2], *rec[2:], *ups)
        lstm = torch.nn.LSTM(i, h).to(cuda)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(args[1].reshape(i, 4 * h).t())
            lstm.weight_hh_l0.copy_(args[2].reshape(h, 4 * h).t())
            lstm.bias_ih_l0.copy_(args[3].reshape(4 * h))
            lstm.bias_hh_l0.zero_()
        x = args[0].clone().requires_grad_()
        _, (h_n, _) = lstm(x)
        inputs = [x] + list(lstm.parameters())

        def lib():
            return torch.autograd.grad(h_n, inputs, ups[0][None],
                                       retain_graph=True)
        main_args = (args[0], args[1], args[2], *rec[2:], ups[0])

        def main_call():
            return lstm_sequence_backward(*main_args, need_dxs=False)
        # before any graph capture of the call (phase 3 holds the count)
        kernels = device_kernels(torch, lambda: lstm_sequence_backward(
            *bwd_args))
        main_kernels = device_kernels(torch, main_call)
        t = {"ms": event_ms(torch, lambda: lstm_sequence_backward(
                 *bwd_args), 500),
             "graph_ms": graph_ms(torch, lambda: lstm_sequence_backward(
                 *bwd_args)),
             "main_ms": event_ms(torch, main_call, 500),
             "main_graph_ms": graph_ms(torch, main_call),
             "plain_ms": event_ms(torch, lambda: lstm_sequence_backward_plain(
                 *bwd_args), 20, warmup=3),
             "library_ms": event_ms(torch, lib, 300)}
        t["bytes_ms"], t["ops_ms"] = sequence_bwd_bound(shape, ICU_T)
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] \
            else "operations"
        t["serial_ms"] = serial_bwd_estimate(shape, ICU_T)
        per[shape] = t
        print(f"[{card}] lstm_sequence_backward B,I,H={shape} T={ICU_T} "
              f"float32: wrapper (fused kernel + reduction) {t['ms']:.5f} "
              f"ms, replayed from a CUDA graph {t['graph_ms']:.5f} ms; the "
              f"offline phase's call (no dxs, h_T's gradient alone) "
              f"{t['main_ms']:.5f} ms, graph {t['main_graph_ms']:.5f} ms; "
              f"plain {t['plain_ms']:.5f} ms, cuDNN nn.LSTM backward "
              f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), serial estimate {t['serial_ms']:.5f} ms; "
              f"device kernels per call (torch.profiler, 20 calls) "
              f"{kernels[1]:g} (the offline phase's {main_kernels[1]:g}): "
              f"{kernels[0]}; launches per offline-phase step 1")
        if any(not fused_lstm_backward(k) for k in (kernels, main_kernels)
               if k[0]):
            raise RuntimeError(f"lstm_sequence_backward {shape}: a call is "
                               f"not the fused kernels alone: {kernels}")
        del lstm, x, h_n, inputs
    torch.backends.cudnn.allow_tf32 = allow_tf32

    case = QWEN_TRAIN_ATTN
    q, kk, v = flash_inputs(torch, case, torch.bfloat16, cuda, seed=1200)
    dout = flash_inputs(torch, case, torch.bfloat16, cuda, seed=1201)[0]
    kw = flash_kwargs(case)
    out, lse = flash_attention_lse(q, kk, v, **kw)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, kk, v))
    o_lib = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)

    def lib():
        return torch.autograd.grad(o_lib, (ql, kl, vl), dout,
                                   retain_graph=True)
    lib_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(lib(), flash_attention_backward(
                      q, kk, v, out, lse, dout, **kw)))
    ft = {"ms": event_ms(torch, lambda: flash_attention_backward(
              q, kk, v, out, lse, dout, **kw), 20, warmup=3),
          "plain_ms": event_ms(torch, lambda: flash_attention_backward_plain(
              q, kk, v, out, lse, dout, **kw), 3, warmup=1),
          "library_ms": event_ms(torch, lib, 20, warmup=3),
          "fwd_ms": event_ms(torch, lambda: flash_attention(q, kk, v, **kw),
                             20, warmup=3),
          "fwd_lse_ms": event_ms(torch, lambda: flash_attention_lse(
              q, kk, v, **kw), 20, warmup=3)}
    by_bytes, by_ops = flash_bwd_bound(case)
    ft["bound_ms"] = max(by_bytes, by_ops)
    ft["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    print(f"[{card}] flash_attention_backward {case} bf16 (tensor cores, "
          f"wgmma + TMA, warp-specialised): {ft['ms']:.4f} ms (3 launches, 4 "
          f"when dK/dV are summed from head-slice partials), plain "
          f"{ft['plain_ms']:.4f} ms, SDPA backward {ft['library_ms']:.4f} "
          f"ms (max |sdpa - kernel| {lib_err:.3e}), kernel / SDPA "
          f"{ft['ms'] / ft['library_ms']:.2f}, bound bytes {by_bytes:.6f} "
          f"ms / operations {by_ops:.6f} ms (kernel / bound "
          f"{ft['ms'] / ft['bound_ms']:.1f}); forward at the same shape "
          f"{ft['fwd_ms']:.5f} ms, with the row log-sum-exp "
          f"{ft['fwd_lse_ms']:.5f} ms; launches per training step 28")
    # gemma2's window and softcap (no SDPA call computes the softcap)
    case = TRAIN_ATTN[1]
    q, kk, v = flash_inputs(torch, case, torch.bfloat16, cuda, seed=1202)
    dout = flash_inputs(torch, case, torch.bfloat16, cuda, seed=1203)[0]
    kw = flash_kwargs(case)
    out, lse = flash_attention_lse(q, kk, v, **kw)
    g_ms = event_ms(torch, lambda: flash_attention_backward(
        q, kk, v, out, lse, dout, **kw), 20, warmup=3)
    by_bytes, by_ops = flash_bwd_bound(case)
    print(f"[{card}] flash_attention_backward {case} bf16 (gemma2's window "
          f"and softcap): {g_ms:.4f} ms, SDPA backward none (softcap), "
          f"bound bytes {by_bytes:.6f} ms / operations {by_ops:.6f} ms "
          f"(kernel / bound {g_ms / max(by_bytes, by_ops):.1f})")
    return per, ft


def time_scan_backward(torch, cuda, card):
    """Phase 7 for the scans' backward kernels at the training paths'
    shapes, bf16, with a cotangent on y alone (as a loss that drops the
    final state gives it): ssm_scan_backward at SSM_TRAIN (its four
    launches: local states, state passes, gradients, reduction) and
    mlstm_chunk_backward at MLSTM_TRAIN (its six), each by events and by
    CUDA-graph replay, beside its plain version and its bound; no single
    PyTorch call computes either. Returns {kernel: times}."""
    from repro_torch.kernels.mlstm_chunk import (mlstm_chunk_backward,
                                                 mlstm_chunk_backward_plain)
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward,
                                              ssm_scan_backward_plain)
    out = {}
    for name, kernel, plain, shape, inputs, bound, launches in (
            ("ssm_scan_backward", ssm_scan_backward, ssm_scan_backward_plain,
             SSM_TRAIN, ssm_inputs, ssm_bwd_bound, 4),
            ("mlstm_chunk_backward", mlstm_chunk_backward,
             mlstm_chunk_backward_plain, MLSTM_TRAIN, mlstm_inputs,
             mlstm_bwd_bound, 6)):
        args = inputs(torch, shape, torch.bfloat16, cuda, seed=1500)
        dy = inputs(torch, shape, torch.bfloat16, cuda, seed=1501)[0]
        t = {"ms": event_ms(torch, lambda: kernel(*args, dy), 20, warmup=3),
             "graph_ms": graph_ms(torch, lambda: kernel(*args, dy),
                                  per_graph=10, replays=5),
             "plain_ms": event_ms(torch, lambda: plain(*args, dy), 2,
                                  warmup=1),
             "library_ms": None}
        by_bytes, by_ops = bound(shape, 2, BF16_FLOPS)
        t["bound_ms"] = max(by_bytes, by_ops)
        t["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        f32_ops = bound(shape, 2, F32_FLOPS)[1]
        out[name] = t
        print(f"[{card}] {name} {shape} bf16 (tensor cores, mma.sync, "
              f"float32 sums): {t['ms']:.4f} ms (CUDA graph "
              f"{t['graph_ms']:.4f} ms; {launches} launches), plain "
              f"{t['plain_ms']:.4f} ms, library none (no single PyTorch "
              f"call computes it), bound bytes {by_bytes:.6f} ms / "
              f"operations {by_ops:.6f} ms at the bf16 rate (kernel / "
              f"bound {t['ms'] / t['bound_ms']:.1f}; at the f32 CUDA-core "
              f"rate the operations would take {f32_ops:.6f} ms)")
        del args, dy
    return out


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
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_plain)
    from repro_torch.kernels.lstm_cell import (lstm_cell, lstm_cell_plain,
                                               lstm_sequence,
                                               lstm_sequence_backward,
                                               lstm_sequence_plain)
    from repro_torch.kernels.mlstm_chunk import (mlstm_chunk,
                                                 mlstm_chunk_backward,
                                                 mlstm_chunk_plain)
    from repro_torch.kernels.ssm_scan import (ssm_scan, ssm_scan_backward,
                                              ssm_scan_plain)
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.lstm import ICULSTM
    from repro_torch.serving.engine import ClassifierEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 matmuls
    cuda = torch.device("cuda")

    # each part's seconds, host clock, as it ends
    clock = [time.perf_counter()] * 2

    def mark(part):
        now = time.perf_counter()
        print(f"[clock] {part}: {now - clock[1]:.1f} s (at "
              f"{now - clock[0]:.1f} s)")
        clock[1] = now

    # 1. environment
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    libs = build.build("lstm_cell", "flash_attention", "flash_attention_bwd",
                       "ssm_scan", "ssm_scan_bwd", "mlstm_chunk",
                       "mlstm_chunk_bwd")
    print(f"build: {len(libs)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    mark("1, 2. environment and build")

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

    mark("3. lstm_cell")
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

    # bf16 inputs (float32 math; h and c in bf16): the step kernel with
    # every input in bf16 and with h alone (h' bf16, c' float32), the
    # sequence kernel with all of its inputs in bf16
    for k, shape in enumerate(TEST_SHAPES + ICU_SHAPES):
        args = cell_inputs(torch, shape, cuda, seed=600 + k)
        for mix, which in (("all", range(6)), ("h", (1,))):
            a16 = [t.to(torch.bfloat16) if j in which else t
                   for j, t in enumerate(args)]
            hk, ck = lstm_cell(*a16)
            hp, cp = lstm_cell_plain(*a16)
            torch.cuda.synchronize()
            err = max(float((hk.float() - hp.float()).abs().max()),
                      float((ck.float() - cp.float()).abs().max()))
            print(f"lstm_cell {shape} bf16 ({mix}): max |kernel - plain| = "
                  f"{err:.3e} (atol {LSTM_BF16_TOL})")
            if (hk.dtype, ck.dtype) != (a16[1].dtype, a16[2].dtype) or \
                    not err <= LSTM_BF16_TOL:
                raise RuntimeError(f"lstm_cell {shape} bf16 ({mix}): "
                                   f"error {err} or dtypes "
                                   f"{hk.dtype}, {ck.dtype}")
    for k, (shape, t_len) in enumerate(
            [(s_, ICU_T) for s_ in ICU_SHAPES]
            + [(s_, t) for s_ in TEST_SHAPES for t in SEQ_TEST_T]):
        args = [t.to(torch.bfloat16) for t in
                sequence_inputs(torch, shape, t_len, cuda, seed=700 + k)]
        hk, ck, hsk = lstm_sequence(*args, return_sequence=True)
        hp, cp, hsp = lstm_sequence_plain(*args, return_sequence=True)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in ((hk, hp), (ck, cp), (hsk, hsp)))
        print(f"lstm_sequence {shape} T={t_len} bf16: max |kernel - plain| "
              f"(h_T, c_T, sequence) = {err:.3e} (atol {LSTM_BF16_TOL})")
        if hk.dtype != torch.bfloat16 or not err <= LSTM_BF16_TOL:
            raise RuntimeError(f"lstm_sequence {shape} T={t_len} bf16: "
                               f"error {err} or dtype {hk.dtype}")

    flash_err = {}
    for k, (case, offset) in enumerate(
            [(c, 0) for c in ATTN_CASES + [ZAMBA_ATTN] + RAGGED_ATTN
             + PADDED_ATTN + LQ_GT_LK_ATTN
             + [c for c, _ in LLM_ATTN.values()] + HOPPER_ATTN]
            + [(VIEW_ATTN, off) for off in VIEW_OFFSETS]):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q, kk, v = flash_inputs(torch, case, dtype, cuda, seed=k)
            if offset:
                q, kk, v = view_inputs(torch, (q, kk, v), offset)
            out = flash_attention(q, kk, v, **flash_kwargs(case))
            want = flash_attention_plain(q, kk, v, **flash_kwargs(case))
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            tol = ATTN_TOL[name]
            rows_ok, rel = True, ""
            if dtype == torch.bfloat16:
                gap = (out.float() - want.float()).norm(dim=-1)
                size = want.float().norm(dim=-1)
                rows_ok = bool((gap <= FLASH_BF16_ROW_REL * size).all())
                row_rel = float((gap / size.clamp_min(1e-30)).max())
                rel = (f", max over rows |kernel - plain| / |plain| = "
                       f"{row_rel:.3e} (<= {FLASH_BF16_ROW_REL})")
            view = f" (views {offset} elements in)" if offset else ""
            print(f"flash_attention {case}{view} {name}: max |kernel - "
                  f"plain| = {err:.3e} (atol = rtol = {tol}){rel}")
            if out.dtype != dtype or not rows_ok or not torch.allclose(
                    out.float(), want.float(), atol=tol, rtol=tol):
                raise RuntimeError(f"flash_attention {case}{view} {name}: "
                                   f"kernel and plain version disagree")
            flash_err[(case, offset, name)] = err

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

    mark("3. forward kernels")
    # the backward kernels (training) against their plain versions
    lstm_bwd_err = check_lstm_backward(torch, cuda)
    flash_bwd_err = check_flash_backward(torch, cuda)
    scan_bwd_err = check_scan_backward(torch, cuda)
    kernels = {"lstm_cell": lstm_cell, "lstm_sequence": lstm_sequence,
               "lstm_sequence_backward": lstm_sequence_backward,
               "flash_attention": flash_attention,
               "flash_attention_backward": flash_attention_backward,
               "ssm_scan": ssm_scan, "ssm_scan_backward": ssm_scan_backward,
               "mlstm_chunk": mlstm_chunk,
               "mlstm_chunk_backward": mlstm_chunk_backward}

    mark("3. backward kernels")
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
    e_pre, e_dec, _, pre, dec = one_group_card_vs_cpu(
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
    e_pre, e_dec, _, pre, dec = one_group_card_vs_cpu(
        torch, xmodel, xp_gpu, prompt, (mlstm_chunk,), "xlstm one group")
    print(f"xlstm-350m full width, 1 group, float32, prompt (1, "
          f"{GEN_PROMPT}): max |cuda - cpu| logits prefill {e_pre:.3e}, 4 "
          f"decode steps {e_dec:.3e} (atol = rtol = {ONE_GROUP_TOL}); "
          f"mlstm_chunk launches prefill {pre[0]}, decode {dec[0]}")
    if pre != (XLSTM_BLOCKS,) or dec != (0,):
        raise RuntimeError(f"xlstm one group: launches prefill {pre}, "
                           f"decode {dec}; expected 7 and 0")
    del xp_gpu

    mark("4. ICU, zamba2, xlstm forwards")
    # their gradients at one group, full width, float32, noised weights:
    # card (the scans' backward kernels) against the CPU (autograd of the
    # plain scans)
    for label, model, cfg, seed, want in (
            ("zamba2-2.7b one group", zmodel, zcfg, 52,
             dict(flash_attention=1, flash_attention_backward=1,
                  ssm_scan=5, ssm_scan_backward=5)),
            ("xlstm-350m one group", xmodel, xcfg, 53,
             dict(mlstm_chunk=XLSTM_BLOCKS,
                  mlstm_chunk_backward=XLSTM_BLOCKS))):
        p_gpu = noised(torch, model.init(torch.Generator(cuda).manual_seed(
            seed), device=cuda), seed=seed + 10)
        _, _, _, launched = grads_card_vs_cpu(
            torch, model, p_gpu, make_batch(cfg, 1, 128, seed=seed), kernels,
            f"{label} gradient, float32, noised, tokens (1, 128)")
        expect_launches(label, launched, dict({n: 0 for n in kernels},
                                              **want))
        del p_gpu
    torch.cuda.empty_cache()

    mark("4. zamba2 and xlstm gradients")
    # the same one-group gradients with remat (each group recomputed in
    # the backward) against those without, on the card
    for label, cfg, seed, kinds in (
            ("zamba2-2.7b one group", zcfg, 52,
             dict(flash_attention=1, ssm_scan=5)),
            ("xlstm-350m one group", xcfg, 53,
             dict(mlstm_chunk=XLSTM_BLOCKS))):
        check_remat_one_group(torch, kernels, label, cfg, seed, kinds)
    torch.cuda.empty_cache()

    mark("4. remat gradients")
    # the rest of the LLM zoo at full width, one group, float32, noised
    for name in ONE_GROUP_CHECKS:
        check_llm_one_group(torch, flash_attention, name)

    mark("4. the LLM zoo")
    # the ICU models' gradients on the card (the repaired fault)
    check_icu_grads(torch, cuda, kernels)

    mark("4. ICU gradients")
    # 5. device search: CUDA vs CPU on integer instances
    check_device_search(torch, cuda)

    mark("5. device search")
    # 6. the main path, with every counter read around it alone
    for k in kernels.values():
        k.launches = 0
    scheduler_torch.tabu_search_batched.calls = 0
    t0 = time.perf_counter()
    results, lb = serve.run(patients=SERVE_PATIENTS, horizon=30.0, seed=0,
                            execute=True, verbose=False)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = lstm_sequence.launches
    step_launches = lstm_cell.launches
    others = {n: k.launches for n, k in kernels.items()
              if n not in ("lstm_sequence", "lstm_cell")}
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
    if (launches, step_launches) != (want, 0) or any(others.values()):
        raise RuntimeError(f"serve.run: lstm_sequence launches {launches}, "
                           f"lstm_cell launches {step_launches}, others "
                           f"{others}; expected {want}, 0 and none")

    mark("6a. serve")
    # the paper's pipeline, examples/serve_hierarchical, on the card
    hier = drive_serve_hierarchical(torch, kernels, card)

    mark("6a. examples.serve_hierarchical")
    # 6b, 6c. the LLM serving paths, each with every counter read around
    # it alone
    zcfg = get_config("zamba2-2.7b")
    zengine, zbatch, zl, _ = drive_generate(
        torch, zcfg, kernels, dict({n: 0 for n in kernels},
                                   flash_attention=zcfg.num_groups,
                                   ssm_scan=5 * zcfg.num_groups), card)
    flash_launches, ssm_launches = zl["flash_attention"], zl["ssm_scan"]
    zamba_flash = flash_launches
    # phase 8's trace while the engine is up; freed before phase 6f
    trace_generate(torch, zengine, zbatch, "zamba2-2.7b", card)
    del zengine, zbatch
    xcfg = get_config("xlstm-350m")
    xengine, xbatch, xl, _ = drive_generate(
        torch, xcfg, kernels, dict({n: 0 for n in kernels},
                                   mlstm_chunk=XLSTM_BLOCKS * xcfg.num_groups),
        card)
    mlstm_launches = xl["mlstm_chunk"]
    trace_generate(torch, xengine, xbatch, "xlstm-350m", card)
    del xengine, xbatch
    torch.cuda.empty_cache()

    mark("6b, 6c. zamba2 and xlstm serving")
    # 6d. the fleet path (its counters read around each run alone)
    fleet_runs = drive_fleet(torch, kernels, card)

    mark("6d. fleet")
    # 6e. the metro engine (its counters read around the phase alone)
    metro_rates = drive_metro(torch, kernels, card)

    mark("6e. metro")
    # 6f. the rest of the LLM zoo at full width (each run's counters read
    # around it alone)
    zoo_launches = drive_llm_zoo(torch, kernels, card)
    flash_launches += sum(zoo_launches.values())

    mark("6f. the LLM zoo")
    # 6g. the training paths (each run's counters read around it alone)
    trained = drive_training(torch, kernels, card)
    zamba_trained = trained["scans"]["zamba2-2.7b"]["launches"]
    xlstm_trained = trained["scans"]["xlstm-350m"]["launches"]
    flash_launches += (trained["qwen2"]["flash_attention"]
                       + zamba_trained["flash_attention"])

    mark("6g. training")
    # 6h. zamba2-2.7b with and without remat on 6g's weights, and the
    # longest lengths that fit (each first run's counters read around it)
    remat = drive_remat(torch, kernels, card, *trained.pop("zamba2"))
    remat_launches = {n: remat[False][n] + remat[True][n] for n in kernels}
    flash_launches += remat_launches["flash_attention"]
    torch.cuda.empty_cache()

    mark("6h. remat")
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
          f"{ft['ops_ms']:.6f} ms, zamba2 main-path launches {zamba_flash}")
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

    # flash_attention at phase 6f's prefill shapes, bf16: the kernel, its
    # bound, and scaled_dot_product_attention where it computes the same
    # function (no softcap; a window only where it does not bite: every
    # query's whole causal past lies inside it)
    for label, (case, per_prefill) in LLM_ATTN.items():
        b, hq, hkv, lq, lk, d, causal, window, softcap = case
        q, kk, v = flash_inputs(torch, case, torch.bfloat16, cuda, seed=210)
        kw = flash_kwargs(case)
        iters = 10 if lq * lk > 4096 * 4096 else 50
        k_ms = event_ms(torch, lambda: flash_attention(q, kk, v, **kw), iters,
                        warmup=3)
        by_bytes, by_ops = flash_bound(case, 2, BF16_FLOPS)
        same = softcap is None and (window is None or window >= lk)
        sdpa_part = "scaled_dot_product_attention: none (softcap or a " \
                    "window that bites)"
        if same:
            gqa = {"enable_gqa": True} if hq != hkv else {}

            def sd():
                return sdpa(q, kk, v, is_causal=causal, **gqa)
            s_ms = event_ms(torch, sd, iters, warmup=3)
            s_err = float((sd().float() - flash_attention(
                q, kk, v, **kw).float()).abs().max())
            sdpa_part = (f"scaled_dot_product_attention {s_ms:.5f} ms (max "
                         f"|sdpa - kernel| {s_err:.3e}), kernel / sdpa "
                         f"{k_ms / s_ms:.3f}")
        print(f"[{card}] flash_attention {label} {case} bf16: kernel "
              f"{k_ms:.5f} ms, {sdpa_part}, bound bytes {by_bytes:.6f} ms / "
              f"operations {by_ops:.6f} ms (bound {max(by_bytes, by_ops):.6f}"
              f" ms, kernel / bound {k_ms / max(by_bytes, by_ops):.2f}), "
              f"launches per prefill {per_prefill}")
        del q, kk, v

    # what the compiler made of the bf16 flash kernels: wgmma (HGMMA) and
    # TMA loads (UTMALDG), no mma.sync (HMMA), wgmmas that ptxas did not
    # serialize, no spills up to D = 128;
    # and the host time of encoding one tensor map (a bf16 forward call
    # encodes four, a backward call four)
    for name, kinds in (("flash_attention", ("flash_bf16_kernel",)),
                        ("flash_attention_bwd",
                         ("flash_bwd_dkdv_bf16_kernel",
                          "flash_bwd_dq_bf16_kernel"))):
        for line, label, spills, n in kernel_report(build, name, kinds):
            print(f"[{card}] {line}")
            width = int(label.split("<")[1].split(",")[0].split(">")[0])
            if n.get("HMMA", 0) or not n.get("HGMMA") or \
                    not n.get("UTMALDG") or n["serialized"] or \
                    (width <= 128 and spills):
                raise RuntimeError(f"{name}.cu {label}: expected HGMMA and "
                                   f"UTMALDG, no HMMA, wgmmas not "
                                   f"serialized and (D <= 128) no spills, "
                                   f"got {n}, {spills} spill bytes")
    import ctypes
    encode = build.load("flash_attention").repro_flash_tensor_map_us
    encode.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    encode.restype = ctypes.c_double
    q = flash_inputs(torch, ZAMBA_ATTN, torch.bfloat16, cuda, seed=200)[0]
    print(f"[{card}] cuTensorMapEncodeTiled: "
          f"{encode(q.data_ptr(), 4, 32, 512, 80, 10000):.3f} us a tensor "
          f"map (host, mean of 10000)")
    del q

    # ssm_scan and mlstm_chunk: the bf16 tensor-core kernels at the main
    # paths' shapes (events; CUDA-graph replay, the device time alone), the
    # float32 CUDA-core kernels at the same shapes, and what the compiler
    # made of them
    for name, kinds in (("ssm_scan", ("ssm_bf16_kernel", "ssm_f32_kernel")),
                        ("mlstm_chunk", ("mlstm_bf16_kernel",
                                         "mlstm_f32_kernel"))):
        for line, *_ in kernel_report(build, name, kinds):
            print(f"[{card}] {line}")
    # the scans' backward kernels: every bf16 kernel that carries the
    # products on the tensor cores (HMMA), the float32 ones on the CUDA
    # cores
    for name, products, others in SCAN_BWD_KERNELS:
        found = set()
        for line, label, _, n in kernel_report(build, name,
                                               products + others):
            print(f"[{card}] {line}")
            kind = label.split("<")[0]
            found.add(kind)
            if kind in products and not (n.get("HMMA") or n.get("HGMMA")):
                raise RuntimeError(f"{name}.cu {label}: a bf16 backward "
                                   f"kernel with no tensor-core "
                                   f"instruction, got {n}")
        if not set(products) <= found:
            raise RuntimeError(f"{name}.cu: kernels {sorted(products)} "
                               f"not all in the build log ({sorted(found)})")
    # the fused LSTM backward and its reduction (float32 and bf16
    # instances, each chain width): registers and spills
    for line, *_ in kernel_report(build, "lstm_cell",
                                  ("lstm_bwd_fused_kernel",
                                   "lstm_bwd_reduce_kernel")):
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

    mark("7. forward timings")
    # the backward kernels at the training paths' shapes
    per_bwd, fbt = time_backward(torch, cuda, card)
    sbt = time_scan_backward(torch, cuda, card)

    mark("7. backward timings")
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.run(patients=SERVE_PATIENTS, horizon=30.0, seed=0,
                  execute=True, verbose=False)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    print_profile(prof, f"[{card}] traced serve.run(patients="
                  f"{SERVE_PATIENTS})", traced_s, 8)
    # the metro path: the tabu run of the pack whose four-ward replans
    # take the most batched device searches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.run_metro(scenario=METRO_BATCHED_PACKS[0], policies=("tabu",),
                        device_threshold=PYTHON_ONLY, device="cuda",
                        verbose=False)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    print_profile(prof, f"[{card}] traced run_metro({METRO_BATCHED_PACKS[0]}"
                  f", tabu)", traced_s, 8)

    mark("8. traces")
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
        "launches": launches + sum(n for _, n in fleet_runs.values())
        + trained["icu"]["lstm_sequence"] + hier["lstm_sequence"],
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
        "max_abs_err": flash_err[(ZAMBA_ATTN, 0, "bfloat16")],
        "ms": ft["ms"], "plain_ms": ft["plain_ms"],
        "bound_ms": max(ft["bytes_ms"], ft["ops_ms"]),
        "bound_by": "bytes" if ft["bytes_ms"] >= ft["ops_ms"]
        else "operations",
        "library_ms": ft["library_ms"]}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:34",
        "launches": ssm_launches + zamba_trained["ssm_scan"]
        + remat_launches["ssm_scan"],
        "max_abs_err": ssm_err[(ZAMBA_SSM, "bfloat16")],
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": max(st["bytes_ms"], st["ops_ms"]),
        "bound_by": "bytes" if st["bytes_ms"] >= st["ops_ms"]
        else "operations",
        "library_ms": None}, {
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk.py:37",
        "launches": mlstm_launches + xlstm_trained["mlstm_chunk"],
        "max_abs_err": mlstm_err[(XLSTM_MLSTM, "bfloat16")],
        "ms": mt["ms"], "plain_ms": mt["plain_ms"],
        "bound_ms": max(mt["bytes_ms"], mt["ops_ms"]),
        "bound_by": "bytes" if mt["bytes_ms"] >= mt["ops_ms"]
        else "operations",
        "library_ms": None}, {
        "name": "lstm_sequence_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:25, its gradient "
                    "through the scan of src/repro/models/lstm.py:52-58 "
                    "(JAX autodiff there; no Pallas backward)",
        "launches": trained["icu"]["lstm_sequence_backward"]
        + hier["lstm_sequence_backward"],
        "max_abs_err": lstm_bwd_err,
        "ms": statistics.mean(t["ms"] for t in per_bwd.values()),
        "graph_ms": statistics.mean(t["graph_ms"] for t in per_bwd.values()),
        "serial_ms": statistics.mean(t["serial_ms"]
                                     for t in per_bwd.values()),
        "plain_ms": statistics.mean(t["plain_ms"] for t in per_bwd.values()),
        "bound_ms": statistics.mean(t["bound_ms"] for t in per_bwd.values()),
        "bound_by": statistics.mode(t["bound_by"] for t in per_bwd.values()),
        "library_ms": statistics.mean(t["library_ms"]
                                      for t in per_bwd.values())}, {
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33, its "
                    "gradient (JAX autodiff there; no Pallas backward)",
        "launches": trained["qwen2"]["flash_attention_backward"]
        + zamba_trained["flash_attention_backward"]
        + remat_launches["flash_attention_backward"],
        "max_abs_err": flash_bwd_err[(QWEN_TRAIN_ATTN, 0, "bfloat16")],
        "ms": fbt["ms"], "plain_ms": fbt["plain_ms"],
        "bound_ms": fbt["bound_ms"], "bound_by": fbt["bound_by"],
        "library_ms": fbt["library_ms"]}] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}_bwd.cu",
        "replaces": f"{replaces}, its gradient (JAX autodiff there; no "
                    f"Pallas backward)",
        "launches": launched, "max_abs_err": scan_bwd_err[(name, shape,
                                                           "bfloat16")],
        "ms": sbt[name]["ms"], "plain_ms": sbt[name]["plain_ms"],
        "bound_ms": sbt[name]["bound_ms"], "bound_by": sbt[name]["bound_by"],
        "library_ms": None} for name, source, replaces, launched, shape in (
            ("ssm_scan_backward", "ssm_scan",
             "src/repro/kernels/ssm_scan.py:34",
             zamba_trained["ssm_scan_backward"]
             + remat_launches["ssm_scan_backward"], SSM_TRAIN),
            ("mlstm_chunk_backward", "mlstm_chunk",
             "src/repro/kernels/mlstm_chunk.py:37",
             xlstm_trained["mlstm_chunk_backward"], MLSTM_TRAIN))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
