#!/usr/bin/env python3
"""Compare checkouts of the PyTorch/CUDA port on one NVIDIA GPU, one
process per checkout:

  * the float32 `lstm_sequence` (one layer, T = 48, as the ICU models call
    it) and `lstm_cell` kernels at chip_smoke.py's ICU shapes, timed by
    CUDA-graph replay (the device time without the host's launch cost),
    median and range of REPEATS measurements;
  * a hash of each float32 LSTM kernel's SASS (`cuobjdump -sass`, the
    instructions without their addresses and encodings), so two checkouts
    can be seen to run the same machine code, and of the forward flash,
    ssm_scan and mlstm_chunk kernels' (what serving launches);
  * the serving forward of `flash_attention` (no autograd) in bf16 at
    zamba2's and qwen2-1.5b's prefill shapes, by CUDA-graph replay;
  * with --flash: the bf16 `flash_attention` kernel against its plain
    version at every shape of chip_smoke.py's phase 3 (same inputs, same
    seeds), under both of its bars: ATTN_TOL's allclose and
    FLASH_BF16_ROW_REL on every output row.

    python3 tools/kernel_ab.py [--flash] TREE [TREE ...]

Each TREE is the root of a checkout: its `src/repro_torch` is imported and
its kernels built there. Trees run in the order given, so `PARENT CHANGE
CHANGE PARENT` alternates two versions within one call. Prints the card's
name and power limit, one line per measurement, and last one JSON object
with every run's results. Exits non-zero without a CUDA device.
"""
import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REPEATS = 5
# float32 LSTM kernels, by their mangled names: before the bf16 inputs the
# sequence kernel was templated on HR alone and the step kernel was not a
# template; after, the sequence kernel's float instance is <HR, float>, and
# since the training forward <HR, float, false> (the serving instance; the
# training instance <HR, float, true> is left out), and the step kernel's
# all-float32 instance is mask 0
SEQ_F32 = re.compile(r"lstm_sequence_kernelILi(\d+)Ef?(?:Lb0E)?E")
CELL_F32 = re.compile(r"lstm_cell_kernel(?:ILi0EE|E)")
# the forward flash kernels' serving instances (<width> before the training
# forward, <width, false> after it)
FLASH_FWD = re.compile(r"flash_(bf16|f32)_kernelILi(\d+)E(?:Lb0E)?E")
# the forward ssm_scan and mlstm_chunk kernels (both dtypes, every width)
SCAN_FWD = re.compile(r"(ssm|mlstm)_(bf16|f32)_kernel(?:ILi(\d+)EE)?")
# bf16 flash forward timed at the serving paths' prefill shapes
FLASH_TIMED = {"zamba2": "ZAMBA_ATTN", "qwen2-1.5b": "qwen2-1.5b"}


def f32_sass(build):
    """{kernel: (instructions, sha256 of their text)} of the float32 LSTM
    kernels in this checkout's built lstm_cell library and of the forward
    kernels in its flash_attention, ssm_scan and mlstm_chunk libraries."""
    import hashlib
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    libs = build.build("lstm_cell", "flash_attention", "ssm_scan",
                       "mlstm_chunk")
    sass = "".join(subprocess.run([str(cuobjdump), "-sass", str(lib)],
                                  capture_output=True, text=True, check=True,
                                  timeout=300).stdout
                   for lib in libs.values())
    out = {}
    for part in sass.split("Function : ")[1:]:
        mangled = part.split()[0]
        seq, cell = SEQ_F32.search(mangled), CELL_F32.search(mangled)
        flash, scan = FLASH_FWD.search(mangled), SCAN_FWD.search(mangled)
        if seq:
            key = f"lstm_sequence_kernel<{seq.group(1)}> float32"
        elif cell:
            key = "lstm_cell_kernel float32"
        elif flash:
            key = f"flash_{flash.group(1)}_kernel<{flash.group(2)}>"
        elif scan:
            key = f"{scan.group(1)}_{scan.group(2)}_kernel" + (
                f"<{scan.group(3)}>" if scan.group(3) else "")
        else:
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", part)
        out[key] = (len(ins),
                    hashlib.sha256("\n".join(ins).encode()).hexdigest()[:16])
    return out


def flash_rows(torch, cs, flash_attention, flash_attention_plain, cuda):
    """Phase 3's bf16 flash checks: per case, max |kernel - plain|, the
    largest row's relative L2 error, and whether each bar holds."""
    rows = []
    tol = cs.ATTN_TOL["bfloat16"]
    for k, case in enumerate(cs.ATTN_CASES + [cs.ZAMBA_ATTN]
                             + cs.RAGGED_ATTN + cs.PADDED_ATTN
                             + cs.LQ_GT_LK_ATTN
                             + [c for c, _ in cs.LLM_ATTN.values()]):
        q, kk, v = cs.flash_inputs(torch, case, torch.bfloat16, cuda, seed=k)
        out = flash_attention(q, kk, v, **cs.flash_kwargs(case)).float()
        want = flash_attention_plain(q, kk, v, **cs.flash_kwargs(case))
        want = want.float()
        gap = (out - want).norm(dim=-1)
        size = want.norm(dim=-1)
        rows.append({
            "case": list(case),
            "max_abs_err": float((out - want).abs().max()),
            "max_row_rel": float((gap / size.clamp_min(1e-30)).max()),
            "atol_ok": bool(torch.allclose(out, want, atol=tol, rtol=tol)),
            "row_ok": bool((gap <= cs.FLASH_BF16_ROW_REL * size).all())})
        print(f"flash_attention {case} bfloat16: max |kernel - plain| "
              f"{rows[-1]['max_abs_err']:.3e} (allclose {tol}: "
              f"{rows[-1]['atol_ok']}), max row |kernel - plain| / |plain| "
              f"{rows[-1]['max_row_rel']:.3e} (<= {cs.FLASH_BF16_ROW_REL}: "
              f"{rows[-1]['row_ok']})", flush=True)
    return rows


def run_one(tree: Path, flash: bool) -> dict:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs           # shapes, inputs, timers, bars
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch sees no CUDA device")

    from repro_torch.kernels import build
    if not Path(build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {build.__file__}, not {tree}'s port")
    from repro_torch.kernels.lstm_cell import lstm_cell, lstm_sequence

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    res = {"tree": str(tree), "card": cs.card_line(),
           "sequence_graph_ms": {}, "cell_graph_ms": {}}
    for k, shape in enumerate(cs.ICU_SHAPES):
        seq = cs.sequence_inputs(torch, shape, cs.ICU_T, cuda, seed=500 + k)
        cell = cs.cell_inputs(torch, shape, cuda, seed=100 + k)
        for key, fn in (("sequence_graph_ms", lambda: lstm_sequence(*seq)),
                        ("cell_graph_ms", lambda: lstm_cell(*cell))):
            ms = [cs.graph_ms(torch, fn) for _ in range(REPEATS)]
            res[key][str(shape)] = {"median": statistics.median(ms),
                                    "min": min(ms), "max": max(ms)}
            print(f"[{res['card']}] {tree.name} {key} {shape}: median "
                  f"{statistics.median(ms):.6f} ms (range {min(ms):.6f}-"
                  f"{max(ms):.6f}, {REPEATS} measurements)", flush=True)
    from repro_torch.kernels.flash_attention import flash_attention
    res["flash_graph_ms"] = {}
    for label, name in FLASH_TIMED.items():
        case = getattr(cs, name) if name.isupper() else cs.LLM_ATTN[name][0]
        q, kk, v = cs.flash_inputs(torch, case, torch.bfloat16, cuda,
                                   seed=200)
        kw = cs.flash_kwargs(case)
        ms = [cs.graph_ms(torch, lambda: flash_attention(q, kk, v, **kw),
                          per_graph=20) for _ in range(REPEATS)]
        res["flash_graph_ms"][label] = {"median": statistics.median(ms),
                                        "min": min(ms), "max": max(ms)}
        print(f"[{res['card']}] {tree.name} flash_attention bf16 {label} "
              f"{case}: median {statistics.median(ms):.6f} ms (range "
              f"{min(ms):.6f}-{max(ms):.6f}, {REPEATS} measurements)",
              flush=True)
    res["sass"] = f32_sass(build)
    for key, (n, digest) in sorted(res["sass"].items()):
        print(f"{tree.name} {key}: {n} SASS instructions, sha256 {digest}")
    if flash:
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        res["flash"] = flash_rows(torch, cs, flash_attention,
                                  flash_attention_plain, cuda)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.trees[0].resolve(), args.flash)))
        return 0
    runs = []
    for tree in args.trees:
        cmd = [sys.executable, __file__, "--one", str(tree)] \
            + (["--flash"] if args.flash else [])
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                              timeout=1800)
        lines = proc.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        if proc.returncode != 0:
            print(f"kernel_ab: {tree} exited {proc.returncode}",
                  file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(lines[-1]))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
