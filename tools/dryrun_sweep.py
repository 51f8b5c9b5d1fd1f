"""Run the port's dry-run sweep one case a process, compare two sweeps, or
count a case's ops by call site.

  python tools/dryrun_sweep.py run OUT [--full] [--multi-pod]
      [--oracle [--unrolled]] [--shapes train_4k,long_500k] [--archs a,b]
      [--jobs 4] [--timeout 420]
    each (arch, shape) case as `python -m repro_torch.launch.dryrun
    --arch A --shape S --out OUT` (with --oracle, `python
    tools/reference_dryrun.py A S --out OUT`: the reference's
    compile) in a process of its own under the time limit, `--jobs` at a
    time; OUT/sweep.tsv gets one line a case: arch, shape, exit code, wall
    seconds, the record's trace (or compile) seconds and its `traced`
    field (or how the oracle read it).

  python tools/dryrun_sweep.py compare SCALED FULL
    for every case in both directories (records the dry-run wrote):
    whether FLOPs, collective bytes and counts by op and argument bytes
    are equal, and the activation peak's relative difference.

  python tools/dryrun_sweep.py compare-reference PORT REF
    for every case in both directories (PORT: records the dry-run wrote;
    REF: records tools/reference_dryrun.py wrote), one JSON line: port /
    reference for FLOPs (the reference's dot FLOPs), argument bytes, and
    collective bytes by op and in total.

  python tools/dryrun_sweep.py peak-rules ARCH SHAPE FULL
    the activation peak of a 16 x 16 case of more than 3 groups by three
    rules, each against the full record in directory FULL: the dry-run's
    own (every op extended by its segment's role), the peak extended
    linearly from 2 and 3 groups, and the 3 groups' peak plus the bytes
    each further group leaves live after the stack's forward; one JSON
    line.

  python tools/dryrun_sweep.py profile ARCH SHAPE [--seconds 120]
      [--multi-pod] [--top 12]
    the case's traced ops by call site (the innermost frame in
    src/repro_torch outside the sharding policy and the dry-run) for the
    given seconds, as one JSON line: the sites with the most ops, the most
    FLOPs and the most collective result bytes (by site and op); a
    backward op counts at its forward op's site ("bwd", from the node's
    traceback under anomaly mode). These are the traced ops' own: what
    the dry-run adds for the repetitions it cuts (groups, microbatches,
    scan steps) is not attributed.

Run from the repository root; it sets PYTHONPATH=src for its children.
Host arithmetic only: no device is measured.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _cases(archs, shapes):
    """The (arch, shape) cases, each arch's in the order train, decode,
    prefill, long: the long traces alternate with short ones, so that
    a pool of jobs seldom runs only long ones at once."""
    sys.path.insert(0, SRC)
    from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES
    order = sorted(INPUT_SHAPES, key=lambda s: (
        "train decode prefill long".split().index(s.split("_")[0])))
    return [(a, s) for a in ARCH_NAMES for s in order
            if (not archs or a in archs) and (not shapes or s in shapes)]


def _record_path(out, arch, shape, multi_pod):
    mesh = "2x16x16" if multi_pod else "16x16"
    return os.path.join(out, f"{arch}_{shape}_{mesh}.json")


def run(args):
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    flags = (["--full"] if args.full else []) + (
        ["--multi-pod"] if args.multi_pod else []) + (
        ["--unrolled"] if args.unrolled else [])

    def one(case):
        arch, shape = case
        if args.oracle:
            cmd = [os.path.join(ROOT, "tools", "reference_dryrun.py"),
                   arch, shape]
        else:
            cmd = ["-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape]
        cmd = ["timeout", str(args.timeout), sys.executable, *cmd, "--out",
               args.out, *flags]
        t0 = time.perf_counter()
        with open(os.path.join(args.out, f"{arch}.{shape}.log"), "w") as log:
            rc = subprocess.call(cmd, stdout=log, stderr=subprocess.STDOUT,
                                 env=env, cwd=ROOT)
        wall = time.perf_counter() - t0
        trace_s, traced = "", ""
        path = _record_path(args.out, arch, shape, args.multi_pod)
        if rc == 0 and os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            trace_s = rec.get("trace_seconds", rec.get("compile_seconds"))
            traced = json.dumps(rec.get("traced", rec.get("read")))
        line = f"{arch}\t{shape}\t{rc}\t{wall:.1f}\t{trace_s}\t{traced}"
        print(line, flush=True)
        return line

    cases = _cases(args.archs, args.shapes)
    with ThreadPoolExecutor(args.jobs) as pool:
        lines = list(pool.map(one, cases))
    with open(os.path.join(args.out, "sweep.tsv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    failed = [ln for ln in lines if ln.split("\t")[2] != "0"]
    print(f"{len(lines) - len(failed)} of {len(lines)} cases exit 0")
    return 1 if failed else 0


def compare(args):
    names = sorted(set(os.listdir(args.scaled)) & set(os.listdir(args.full)))
    worst = 0.0
    for name in names:
        if not name.endswith(".json"):
            continue
        with open(os.path.join(args.scaled, name)) as f:
            s = json.load(f)
        with open(os.path.join(args.full, name)) as f:
            g = json.load(f)
        ps = s["memory"]["activation_peak_bytes"]["Total"]
        pg = g["memory"]["activation_peak_bytes"]["Total"]
        rel = (ps - pg) / pg
        worst = max(worst, abs(rel))
        same = {"flops": s["flops"] == g["flops"],
                "collectives": s["collectives"] == g["collectives"],
                "arguments": s["memory"]["argument_bytes_by_tree"]
                == g["memory"]["argument_bytes_by_tree"],
                "peak_by_type": s["memory"]["activation_peak_bytes"]
                == g["memory"]["activation_peak_bytes"]}
        print(json.dumps({"case": name[:-5], **same, "peak_full": pg,
                          "peak_scaled": ps, "peak_rel": rel,
                          "traced": s["traced"],
                          "trace_s": [s["trace_seconds"],
                                      g["trace_seconds"]]}))
    print(f"largest peak difference {worst:.3e}")
    return 0


def compare_reference(args):
    """Per case in both directories: the port's record over the
    reference oracle's (tools/reference_dryrun.py): FLOPs over dot FLOPs,
    argument bytes, collective bytes by op and in total (None where the
    reference moves none)."""
    def ratio(a, b):
        return a / b if b else (None if a else 1.0)

    names = sorted(n for n in set(os.listdir(args.port))
                   & set(os.listdir(args.ref)) if n.endswith(".json"))
    for name in names:
        with open(os.path.join(args.port, name)) as f:
            p = json.load(f)
        with open(os.path.join(args.ref, name)) as f:
            r = json.load(f)
        pc, rc = p["collectives"], r["collectives"]
        print(json.dumps({
            "case": name[:-5], "flops": ratio(p["flops"], r["dot_flops"]),
            "arguments": ratio(p["memory"]["argument_size_in_bytes"],
                               r["memory"]["argument_size_in_bytes"]),
            "argument_bytes": [p["memory"]["argument_size_in_bytes"],
                               r["memory"]["argument_size_in_bytes"]],
            "collectives": ratio(pc["total_bytes"], rc["total_bytes"]),
            "collectives_by_op": {op: ratio(pc["bytes_by_op"][op],
                                            rc["bytes_by_op"][op])
                                  for op in rc["bytes_by_op"]},
            "port": {"flops": p["flops"],
                     "collective_bytes": pc["total_bytes"]},
            "ref": {"dot_flops": r["dot_flops"],
                    "collective_bytes": rc["total_bytes"],
                    "read": r["read"],
                    "compile_seconds": r["compile_seconds"]}}))
    return 0


def peak_rules(args):
    sys.path.insert(0, SRC)
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import policy

    shape = INPUT_SHAPES[args.shape]
    cfg = dryrun.variant_for_shape(get_config(args.arch), shape)
    depth = dryrun._depth(cfg)
    mb = (dryrun.TRAIN_MICROBATCHES.get(args.arch, 1)
          if shape.kind == "train" else 1)
    dryrun.fake_process_group(256)
    mesh = make_production_mesh(device="cpu")
    t = {k: dryrun._trace(dryrun.at_depth(cfg, k), shape, mesh, mb,
                          policy.residual_for(cfg), True, timeline=True)
         for k in (2, 3)}
    p2, p3 = (t[k]["peak"]["Total"] for k in (2, 3))
    # live bytes at the first op after the first stack call's last group
    after = {k: t[k]["timeline"][("gap", 0, "fwd", k - 1)][0][-1]
             for k in (2, 3)}
    rules = {"dryrun": dryrun._extended_peak(
                 t[2]["timeline"], t[3]["timeline"], 2, 3, depth,
                 t[3]["types"])["Total"],
             "linear": p3 + (depth - 3) * (p3 - p2),
             "saved": p3 + (depth - 3) * (after[3] - after[2])}
    with open(_record_path(args.full, args.arch, args.shape, False)) as f:
        want = json.load(f)["memory"]["activation_peak_bytes"]["Total"]
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "groups": depth, "full": want, **rules,
                      **{f"{k}_rel": (v - want) / want
                         for k, v in rules.items()}}))
    return 0


def profile(args):
    sys.path.insert(0, SRC)
    import torch
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun

    src = os.path.join(SRC, "repro_torch") + os.sep
    skip = ("sharding/policy.py", "launch/dryrun.py")
    engine = "training/train_loop.py"     # where the step calls autograd
    counts = collections.Counter()
    flops = collections.Counter()
    coll = collections.Counter()
    registry = FlopCounterMode().flop_registry

    def _site():
        """The innermost frame in src/repro_torch outside `skip`; in the
        backward (the autograd engine called from the train step), that
        of the forward op whose node runs: "bwd" and the node's
        traceback, which anomaly mode keeps."""
        f, site = sys._getframe(2), "<autograd engine>"
        while f is not None:
            name = f.f_code.co_filename
            if name.startswith(src) and not name.endswith(skip):
                site = f"{name[len(src):]}:{f.f_lineno}"
                break
            f = f.f_back
        node = torch._C._current_autograd_node()
        if node is None or not site.startswith(engine):
            return site
        for frame in reversed(node.metadata.get("traceback_", [])):
            m = re.match(r'\s*File "([^"]+)", line (\d+)', frame)
            if m and m.group(1).startswith(src) and not m.group(
                    1).endswith(skip):
                return f"bwd {m.group(1)[len(src):]}:{m.group(2)}"
        return site

    class Sites(TorchDispatchMode):
        """Each rank-local op by call site: the ops, and what the
        recorder counts of them (the same filter: ops on the trace's fake
        tensors), FLOPs and collective result bytes."""

        def __init__(self):
            super().__init__()
            self.entry_mode = active_fake_mode()

        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            site = _site()
            counts[site] += 1
            out = func(*fargs, **kwargs)
            if active_fake_mode() is self.entry_mode and any(
                    isinstance(t, FakeTensor)
                    for t in pytree.tree_leaves(out)):
                packet = func._overloadpacket
                if packet in registry:
                    flops[site] += int(registry[packet](*fargs, **kwargs,
                                                        out_val=out))
                op = dryrun.collective_name(str(func))
                if op is not None:
                    coll[f"{site} {op}"] += dryrun._result_bytes(out)
            return out

    recorder_cls, started = dryrun.CaseRecorder, []

    def recorder(*a, **k):
        rec, sites = recorder_cls(*a, **k), Sites()

        class Both:
            def __enter__(self):
                if not started:
                    started.append(time.perf_counter())
                    signal.alarm(args.seconds)
                rec.__enter__()
                sites.__enter__()
                return self

            def __exit__(self, *exc):
                sites.__exit__(*exc)
                rec.__exit__(*exc)

            def __getattr__(self, name):
                return getattr(rec, name)

        return Both()

    stopped = []

    def stop(*_):
        stopped.append(True)
        raise TimeoutError

    dryrun.CaseRecorder = recorder
    signal.signal(signal.SIGALRM, stop)
    status = "traced"
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=False):
            dryrun.run_case(args.arch, args.shape, verbose=False,
                            multi_pod=args.multi_pod)
    except Exception:  # noqa: BLE001 -- DTensor may wrap the alarm's error
        if not stopped:
            raise
        status = "cut"
    signal.alarm(0)
    seconds = time.perf_counter() - started[0]
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "mesh": "2x16x16" if args.multi_pod else "16x16",
                      "status": status, "seconds": round(seconds, 1),
                      "ops": sum(counts.values()),
                      "top": counts.most_common(args.top),
                      "flops": sum(flops.values()),
                      "top_flops": flops.most_common(args.top),
                      "collective_bytes": sum(coll.values()),
                      "top_collectives": coll.most_common(args.top)}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("out")
    r.add_argument("--full", action="store_true")
    r.add_argument("--multi-pod", action="store_true")
    r.add_argument("--oracle", action="store_true",
                   help="the reference's compile (tools/reference_dryrun.py)")
    r.add_argument("--unrolled", action="store_true",
                   help="with --oracle: every jax.lax.scan unrolled")
    r.add_argument("--archs", type=lambda s: s.split(","), default=())
    r.add_argument("--shapes", type=lambda s: s.split(","), default=())
    r.add_argument("--jobs", type=int, default=4)
    r.add_argument("--timeout", type=int, default=420)
    c = sub.add_parser("compare")
    c.add_argument("scaled")
    c.add_argument("full")
    cr = sub.add_parser("compare-reference")
    cr.add_argument("port")
    cr.add_argument("ref")
    k = sub.add_parser("peak-rules")
    k.add_argument("arch")
    k.add_argument("shape")
    k.add_argument("full")
    p = sub.add_parser("profile")
    p.add_argument("arch")
    p.add_argument("shape")
    p.add_argument("--seconds", type=int, default=120)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    return {"run": run, "compare": compare,
            "compare-reference": compare_reference, "peak-rules": peak_rules,
            "profile": profile}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
