#!/usr/bin/env python3
"""Compare checkouts of the PyTorch/CUDA port on one NVIDIA GPU, one
process per checkout:

  * the float32 `lstm_sequence` (one layer, T = 48, as the ICU models call
    it) and `lstm_cell` kernels at chip_smoke.py's ICU shapes, timed by
    CUDA-graph replay (the device time without the host's launch cost),
    median and range of REPEATS measurements;
  * the serving forward of `flash_attention` (no autograd) in bf16 at
    every prefill shape of chip_smoke.py's LLM_ATTN and at zamba2's, and
    `flash_attention_backward` in bf16 at qwen2-1.5b's training shape, by
    CUDA-graph replay, beside scaled_dot_product_attention where it
    computes the same function (its backward by CUDA events: autograd
    cannot be captured), and each shape's bound;
  * `ssm_scan_backward` at zamba2-2.7b's training shape (SSM_TRAIN) and
    `mlstm_chunk_backward` at xlstm-350m's (MLSTM_TRAIN), bf16, with a
    cotangent on y alone, by CUDA-graph replay, beside their bounds;
  * the float32 `lstm_sequence_backward` at the three ICU training shapes
    (B = 32, T = 48) by CUDA-graph replay: the call chip_smoke.py's phase 7
    times (h_T's gradient, zeros on c_T and the sequence, dxs computed)
    and, where the tree's wrapper takes `need_dxs`, the offline phase's
    call (h_T's gradient alone, no dxs), beside the bound and
    `serial_bwd_estimate`;
  * a hash of the SASS of every kernel in every built library
    (`cuobjdump -sass`, the instructions without their addresses and
    encodings), keyed by mangled name, and of a second build of each
    source; after the runs, the kernels whose hash differs between trees
    (and which of them also differ between two builds of one tree: nvcc
    does not reproduce every kernel's SASS) or that only some trees have,
    by library, so two checkouts can be seen to run the same machine code
    where nothing was meant to change;
  * with --flash: the bf16 `flash_attention` kernel against its plain
    version at every shape of chip_smoke.py's phase 3 (same inputs, same
    seeds), under both of its bars: ATTN_TOL's allclose and
    FLASH_BF16_ROW_REL on every output row.

    python3 tools/kernel_ab.py [--flash] [--out FILE] TREE [TREE ...]

Each TREE is the root of a checkout: its `src/repro_torch` is imported and
its kernels built there. Trees run in the order given, so `PARENT CHANGE
CHANGE PARENT` alternates two versions within one call. Prints the card's
name and power limit, one line per measurement, the SASS verdict, and last
one JSON object with every run's timings; with --out, every run's whole
record (the SASS hashes too) goes to FILE as JSON. Exits non-zero without
a CUDA device.
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
LIBRARIES = ("lstm_cell", "flash_attention", "flash_attention_bwd",
             "ssm_scan", "ssm_scan_bwd", "mlstm_chunk", "mlstm_chunk_bwd")


def all_sass(build, libs=None):
    """{mangled kernel name: (instructions, sha256 of their text)} of every
    kernel in this checkout's built libraries (or in `libs`)."""
    import hashlib
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    libs = libs or build.build(*LIBRARIES)
    out = {}
    for lib_name, lib in libs.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", part)
            # an anonymous namespace's mangled name carries a hash of the
            # source's path, which differs between checkouts
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}",
                          "_ZN_anon_", part.split()[0])
            out[f"{lib_name}/{name}"] = (len(ins), hashlib.sha256(
                "\n".join(ins).encode()).hexdigest()[:16])
    return out


def rebuilt_sass(build):
    """all_sass of a second build of every source (the same flags, all
    nvcc processes at once, into _build/rebuild/): nvcc does not give every
    kernel the same SASS on every build of one source, so a kernel whose
    hash differs between trees is only a changed kernel if its two builds
    in one tree agree."""
    out = build.BUILD_DIR / "rebuild"
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: out / f"lib{name}.so" for name in LIBRARIES}
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                               str(lib), str(build.CSRC / f"{name}.cu")],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
             for name, lib in libs.items()]
    if any(p.wait(timeout=900) for p in procs):
        raise RuntimeError("kernel_ab: a second build failed")
    return all_sass(build, libs)


def timed(torch, cs, fn, per_graph):
    ms = [cs.graph_ms(torch, fn, per_graph=per_graph) for _ in range(REPEATS)]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def flash_times(torch, cs, cuda, card, name):
    """Graph-replayed bf16 flash forward at ZAMBA_ATTN and every LLM_ATTN
    shape, the backward at QWEN_TRAIN_ATTN, SDPA where it computes the
    same function (no softcap, no window that bites), and the bounds."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_lse)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for label, case in [("zamba2", cs.ZAMBA_ATTN)] + [
            (k, c) for k, (c, _) in cs.LLM_ATTN.items()]:
        b, hq, hkv, lq, lk, d, causal, window, softcap = case
        q, kk, v = cs.flash_inputs(torch, case, torch.bfloat16, cuda,
                                   seed=200)
        kw = cs.flash_kwargs(case)
        per = 5 if lq * lk > 4096 * 4096 else 20
        row = {"case": list(case),
               "kernel": timed(torch, cs, lambda: flash_attention(
                   q, kk, v, **kw), per),
               "bound_ms": max(cs.flash_bound(case, 2, cs.BF16_FLOPS))}
        if softcap is None and (window is None or window >= lk):
            gqa = {"enable_gqa": True} if hq != hkv else {}
            row["sdpa"] = timed(torch, cs, lambda: sdpa(
                q, kk, v, is_causal=causal, **gqa), per)
        out[label] = row
        sd = (f", SDPA median {row['sdpa']['median']:.6f} ms"
              if "sdpa" in row else ", SDPA none")
        print(f"[{card}] {name} flash_attention bf16 {label} {case}: median "
              f"{row['kernel']['median']:.6f} ms (range "
              f"{row['kernel']['min']:.6f}-{row['kernel']['max']:.6f}, "
              f"{REPEATS} measurements){sd}, bound {row['bound_ms']:.6f} ms",
              flush=True)
        del q, kk, v
    case = cs.QWEN_TRAIN_ATTN
    q, kk, v = cs.flash_inputs(torch, case, torch.bfloat16, cuda, seed=1200)
    dout = cs.flash_inputs(torch, case, torch.bfloat16, cuda, seed=1201)[0]
    kw = cs.flash_kwargs(case)
    o, lse = flash_attention_lse(q, kk, v, **kw)
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, kk, v))
    o_lib = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)
    row = {"case": list(case),
           "kernel": timed(torch, cs, lambda: flash_attention_backward(
               q, kk, v, o, lse, dout, **kw), 5),
           # autograd's engine cannot be captured in a CUDA graph: SDPA's
           # backward (one fused call) by CUDA events instead
           "sdpa": {"median": cs.event_ms(torch, lambda: torch.autograd.grad(
               o_lib, (ql, kl, vl), dout, retain_graph=True), 20, warmup=3)},
           "bound_ms": max(cs.flash_bwd_bound(case))}
    out["qwen2-1.5b training backward"] = row
    print(f"[{card}] {name} flash_attention_backward bf16 {case}: median "
          f"{row['kernel']['median']:.6f} ms (range "
          f"{row['kernel']['min']:.6f}-{row['kernel']['max']:.6f}), SDPA "
          f"backward {row['sdpa']['median']:.6f} ms (events), bound "
          f"{row['bound_ms']:.6f} ms", flush=True)
    return out


def scan_backward_times(torch, cs, cuda, card, name):
    """Graph-replayed bf16 `ssm_scan_backward` at SSM_TRAIN and
    `mlstm_chunk_backward` at MLSTM_TRAIN, a cotangent on y alone (the
    inputs of chip_smoke.py's phase 7), beside their bounds."""
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_backward
    from repro_torch.kernels.ssm_scan import ssm_scan_backward
    out = {}
    for label, kernel, shape, inputs, bound in (
            ("ssm_scan_backward", ssm_scan_backward, cs.SSM_TRAIN,
             cs.ssm_inputs, cs.ssm_bwd_bound),
            ("mlstm_chunk_backward", mlstm_chunk_backward, cs.MLSTM_TRAIN,
             cs.mlstm_inputs, cs.mlstm_bwd_bound)):
        args = inputs(torch, shape, torch.bfloat16, cuda, seed=1500)
        dy = inputs(torch, shape, torch.bfloat16, cuda, seed=1501)[0]
        row = {"case": list(shape),
               "kernel": timed(torch, cs, lambda: kernel(*args, dy), 3),
               "bound_ms": max(bound(shape, 2, cs.BF16_FLOPS))}
        out[label] = row
        print(f"[{card}] {name} {label} bf16 {shape}: median "
              f"{row['kernel']['median']:.6f} ms (range "
              f"{row['kernel']['min']:.6f}-{row['kernel']['max']:.6f}, "
              f"{REPEATS} measurements), bound {row['bound_ms']:.6f} ms",
              flush=True)
        del args, dy
    return out


def lstm_backward_times(torch, cs, cuda, card, name):
    """Graph-replayed float32 `lstm_sequence_backward` at the ICU training
    shapes: phase 7's call and, where the wrapper takes `need_dxs`, the
    offline phase's; beside the bound and the serial estimate."""
    import inspect

    from repro_torch.kernels.lstm_cell import (lstm_sequence_backward,
                                               lstm_sequence_train)
    offline = "need_dxs" in inspect.signature(
        lstm_sequence_backward).parameters
    out = {}
    for k, shape in enumerate(cs.TRAIN_LSTM_SHAPES[:3]):
        b, _, h = shape
        args = cs.sequence_inputs(torch, shape, cs.ICU_T, cuda, seed=1100 + k)
        rec = lstm_sequence_train(*args)
        dh = torch.randn(b, h, device=cuda)
        call = (args[0], args[1], args[2], *rec[2:], dh,
                torch.zeros(b, h, device=cuda),
                torch.zeros(cs.ICU_T, b, h, device=cuda))
        row = {"case": list(shape),
               "kernel": timed(torch, cs, lambda: lstm_sequence_backward(
                   *call), 100),
               "bound_ms": max(cs.sequence_bwd_bound(shape, cs.ICU_T)),
               "serial_ms": cs.serial_bwd_estimate(shape, cs.ICU_T)}
        if offline:
            row["offline_call"] = timed(
                torch, cs, lambda: lstm_sequence_backward(
                    *call[:7], need_dxs=False), 100)
        out[str(shape)] = row
        off = (f"; the offline phase's call median "
               f"{row['offline_call']['median']:.6f} ms (range "
               f"{row['offline_call']['min']:.6f}-"
               f"{row['offline_call']['max']:.6f})" if offline else "")
        print(f"[{card}] {name} lstm_sequence_backward float32 {shape} "
              f"T={cs.ICU_T}: median {row['kernel']['median']:.6f} ms "
              f"(range {row['kernel']['min']:.6f}-"
              f"{row['kernel']['max']:.6f}, {REPEATS} measurements){off}, "
              f"bound {row['bound_ms']:.6f} ms, serial estimate "
              f"{row['serial_ms']:.6f} ms", flush=True)
        del args, rec, call
    return out


def flash_rows(torch, cs, flash_attention, flash_attention_plain, cuda):
    """Phase 3's bf16 flash checks: per case, max |kernel - plain|, the
    largest row's relative L2 error, and whether each bar holds."""
    rows = []
    tol = cs.ATTN_TOL["bfloat16"]
    for k, case in enumerate(cs.ATTN_CASES + [cs.ZAMBA_ATTN]
                             + cs.RAGGED_ATTN + cs.PADDED_ATTN
                             + cs.LQ_GT_LK_ATTN
                             + [c for c, _ in cs.LLM_ATTN.values()]
                             + cs.HOPPER_ATTN):
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
    res["flash_graph_ms"] = flash_times(torch, cs, cuda, res["card"],
                                        tree.name)
    res["scan_backward_graph_ms"] = scan_backward_times(
        torch, cs, cuda, res["card"], tree.name)
    res["lstm_backward_graph_ms"] = lstm_backward_times(
        torch, cs, cuda, res["card"], tree.name)
    res["sass"] = all_sass(build)
    again = rebuilt_sass(build)
    res["sass_unstable"] = sorted(n for n, h in res["sass"].items()
                                  if n in again and again[n] != h)
    print(f"{tree.name}: {len(res['sass'])} kernels hashed, "
          f"{len(res['sass_unstable'])} with other SASS on a second build",
          flush=True)
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
    ap.add_argument("--out", type=Path)
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
    # kernels whose SASS differs between trees, or that some trees lack
    names = sorted(set().union(*(r["sass"] for r in runs)))
    differ = [n for n in names if all(n in r["sass"] for r in runs)
              and len({tuple(r["sass"][n]) for r in runs}) > 1]
    partial = [n for n in names if not all(n in r["sass"] for r in runs)]
    same = len(names) - len(differ) - len(partial)
    unstable = set().union(*(r["sass_unstable"] for r in runs))
    print(f"SASS: {same} kernels identical in every tree; {len(differ)} "
          f"differ, of which {len([n for n in differ if n in unstable])} "
          f"also differ between two builds of one tree "
          f"({[n for n in differ if n in unstable]}) and "
          f"{len([n for n in differ if n not in unstable])} do not "
          f"({[n for n in differ if n not in unstable]}); {len(partial)} "
          f"only in some trees: "
          + "; ".join(f"{n} in {[r['tree'] for r in runs if n in r['sass']]}"
                      for n in partial))
    by_lib = {}
    for n in differ + partial:
        lib = n.split("/", 1)[0]
        stable = n in partial or n not in unstable
        by_lib.setdefault(lib, [0, 0])[0 if stable else 1] += 1
    print("SASS by library (kernels that differ between trees or are only "
          "in some, [stable within a tree, unstable]): "
          + (", ".join(f"{lib} {v}" for lib, v in sorted(by_lib.items()))
             or "none"))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"runs": runs, "sass_differ": differ,
                                        "sass_partial": partial}))
    print(json.dumps({"runs": [{k: v for k, v in r.items() if k != "sass"}
                               for r in runs],
                      "sass_identical": same, "sass_differ": differ,
                      "sass_partial": partial}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
