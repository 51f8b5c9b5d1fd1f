"""The reference's dry-run (src/repro/launch/dryrun.py) as the oracle of
the port's: each case compiled as the reference compiles it, on the
reference's production mesh of host devices, and read like for like with
the port's records.

  python tools/reference_dryrun.py ARCH SHAPE [--multi-pod] [--unrolled]
      [--out DIR] [--hlo FILE]
    one case in this process; one JSON record, written to
    DIR/{arch}_{shape}_{mesh}.json (as tools/dryrun_sweep.py names the
    port's) and printed as the last line.

  python tools/dryrun_sweep.py run OUT --oracle [--multi-pod] [--unrolled]
    every case so, a process each.

The reference is imported, not edited. `import repro.launch.dryrun` sets
XLA_FLAGS to 512 host devices before JAX loads; in this process only, its
`make_production_mesh` is rebound to one that makes `Auto` axes (JAX
0.9's `jax.make_mesh` makes `Explicit` axes, which the reference's
`with_sharding_constraint` refuses). Nothing in `src/repro_torch` imports
this file.

A record reads the partitioned HLO of the compiled step:

  * `dot_flops`: the sum over `dot` and `convolution` ops of 2 x result
    elements x contracted size (a convolution's kernel window times its
    input features), what the port's FlopCounterMode count measures;
  * `collectives`: the reference's own `collective_bytes` (result bytes and
    counts by op);
  * `memory`: the reference's `memory_dict` of the compiled step;
  * `lower_seconds`, `compile_seconds`, and `read`: how the sums were
    taken.

XLA lowers each `jax.lax.scan` to a `while` whose body it counts once
(`cost_analysis()` of gemma-2b train_4k halves with each doubling of its
microbatches). So the sums are read **scaled** (the default): per HLO
computation, multiplied by the product of the trip counts of the loops
that enclose it (`known_trip_count` in each `while`'s backend config; a
fusion, call or branch counts once per call), or **unrolled**
(`--unrolled`): every `jax.lax.scan` lowered with `unroll=True`, so that
no loop is left to scale. Scaling is exact for dots; unrolling changes
XLA's plan, so collective bytes agree only roughly between the two.

Run from the repository root. Host arithmetic only: no device is
measured.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def reference():
    """The reference's dry-run module, its production mesh rebound to
    `Auto` axes (in this process only)."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import repro.launch.dryrun as ref   # sets XLA_FLAGS before jax loads
    import jax
    from jax.sharding import AxisType

    def make_production_mesh(*, multi_pod: bool = False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))

    ref.make_production_mesh = make_production_mesh
    return ref


@contextlib.contextmanager
def unrolled_scans():
    """Every `jax.lax.scan` lowered with `unroll=True` (the reference calls
    it as `jax.lax.scan`, so rebinding the attribute reaches every
    call)."""
    import jax
    scan = jax.lax.scan
    jax.lax.scan = functools.partial(scan, unroll=True)
    try:
        yield
    finally:
        jax.lax.scan = scan


# ------------------------------------------------------------ HLO reading
_DEF = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_HEAD = re.compile(r"^(ENTRY\s+)?%([\w.\-]+)\s*\(")
_DIMS = re.compile(r"^\w+\[([\d,]*)\]")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLEE = re.compile(r"\b(condition|body|calls|to_apply|true_computation|"
                     r"false_computation)=%([\w.\-]+)")
_BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")


def _closing(s: str, start: int) -> int:
    """Index of the bracket closing the one at `start`."""
    depth = 0
    for i in range(start, len(s)):
        if s[i] in "([{":
            depth += 1
        elif s[i] in ")]}":
            depth -= 1
            if depth == 0:
                return i
    raise ValueError(f"unbalanced: {s[start:start + 80]}")


def _split_def(rhs: str):
    """(shape text, opcode, operand text, attribute text) of an
    instruction's right-hand side."""
    if rhs.startswith("("):
        end = _closing(rhs, 0) + 1
    else:
        end = rhs.index(" ")
    shape, rest = rhs[:end], rhs[end:].lstrip()
    op_end = rest.index("(")
    close = _closing(rest, op_end)
    return shape, rest[:op_end], rest[op_end + 1:close], rest[close + 1:]


def _dims(shape: str) -> list:
    m = _DIMS.match(shape.strip())
    if not m:
        raise ValueError(f"not an array shape: {shape[:80]}")
    return [int(d) for d in m.group(1).split(",") if d]


def _operands(text: str) -> list:
    """Operand names (the shapes, where printed inline, are dropped)."""
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    out.append(cur)
    names = []
    for part in out:
        m = re.search(r"%([\w.\-]+)", part)
        names.append(m.group(1) if m else None)
    return names


def _attr_list(attrs: str, key: str) -> list:
    m = re.search(rf"\b{key}=\{{([\d,]*)\}}", attrs)
    return [int(d) for d in m.group(1).split(",") if d] if m else []


def dot_flops(opcode: str, shape: str, operands: list, attrs: str,
              shapes: dict) -> int:
    """2 x result elements x contracted size of a `dot`, or of a
    `convolution` (its kernel's window times its input features)."""
    out = math.prod(_dims(shape))
    if opcode == "dot":
        lhs = _dims(shapes[operands[0]])
        k = math.prod(lhs[i]
                      for i in _attr_list(attrs, "lhs_contracting_dims"))
        return 2 * out * k
    kernel = _dims(shapes[operands[1]])
    labels = re.search(r"dim_labels=\w+_(\w+)->", attrs).group(1)
    k = math.prod(n for n, c in zip(kernel, labels) if c != "o")
    return 2 * out * k


def parse_hlo(text: str) -> tuple:
    """({computation: [(name, shape, opcode, operands, attrs)]}, the entry
    computation's name)."""
    comps, entry, cur = {}, None, None
    for line in text.splitlines():
        if cur is None:
            m = _HEAD.match(line)
            if m and line.rstrip().endswith("{"):
                cur = m.group(2)
                comps[cur] = []
                if m.group(1):
                    entry = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _DEF.match(line)
        if m:
            name, rhs = m.groups()
            comps[cur].append((name, *_split_def(rhs)))
    if entry is None:
        raise ValueError("no ENTRY computation")
    return comps, entry


def multiplicities(comps: dict, entry: str) -> tuple:
    """({computation: times it runs per call of the entry}, [while
    loops as (trip count or None, multiplicity of the loop op)],
    conditionals). A `while` body runs its trip count per loop run (once
    when XLA does not know it), its condition one more time; every other
    callee once per call."""
    calls = {c: [] for c in comps}
    loops, conditionals = [], 0
    for comp, insts in comps.items():
        for name, _, opcode, _, attrs in insts:
            trip = None
            if opcode == "while":
                m = _TRIP.search(attrs)
                trip = int(m.group(1)) if m else None
                loops.append((comp, trip))
            if opcode == "conditional":
                conditionals += 1
            for key, callee in _CALLEE.findall(attrs):
                k = 1
                if key == "body":
                    k = trip if trip is not None else 1
                elif key == "condition":
                    k = (trip if trip is not None else 1) + 1
                calls[comp].append((callee, k))
            for branch in _BRANCHES.findall(attrs):
                for callee in re.findall(r"%([\w.\-]+)", branch):
                    calls[comp].append((callee, 1))
    order, seen = [], set()

    def visit(c):
        if c in seen:
            return
        seen.add(c)
        for callee, _ in calls[c]:
            visit(callee)
        order.append(c)

    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))
    visit(entry)
    mult = {c: 0 for c in comps}
    mult[entry] = 1
    for c in reversed(order):            # callers before callees
        for callee, k in calls[c]:
            mult[callee] += mult[c] * k
    return mult, [(trip, mult[comp]) for comp, trip in loops], conditionals


def read_hlo(text: str, collective_bytes) -> dict:
    """The scaled sums of a partitioned HLO module: dot FLOPs, and
    `collective_bytes` (the reference's parser) of each computation's
    lines, each computation's part times its multiplicity."""
    comps, entry = parse_hlo(text)
    mult, loops, conditionals = multiplicities(comps, entry)
    shapes = {name: shape for insts in comps.values()
              for name, shape, *_ in insts}
    flops = 0
    coll = {"bytes_by_op": {}, "count_by_op": {}}
    lines = {c: [] for c in comps}
    for comp, insts in comps.items():
        for name, shape, opcode, operands, attrs in insts:
            if opcode in ("dot", "convolution") and mult[comp]:
                flops += mult[comp] * dot_flops(opcode, shape,
                                                _operands(operands), attrs,
                                                shapes)
            lines[comp].append(f"  %{name} = {shape} {opcode}({operands})"
                               f"{attrs}")
    for comp, body in lines.items():
        part = collective_bytes("\n".join(body))
        for key in ("bytes_by_op", "count_by_op"):
            for op, v in part[key].items():
                coll[key][op] = coll[key].get(op, 0) + mult[comp] * v
    coll["total_bytes"] = sum(coll["bytes_by_op"].values())
    return {"dot_flops": flops, "collectives": coll,
            "while_loops": [{"trip_count": t, "runs": m} for t, m in loops],
            "conditionals": conditionals}


# ---------------------------------------------------------------- cases
def compile_case(ref, cfg, shape, *, multi_pod: bool = False,
                 microbatches: int = 1, unrolled: bool = False,
                 hlo_path: str | None = None) -> dict:
    """One step compiled as the reference's `run_case` compiles it (its
    `build_case`, its residual layout, `jax.jit(...).lower(...).compile()`
    on its production mesh) for the given `cfg` and `shape`, read scaled
    or unrolled."""
    import jax
    from repro.sharding import policy
    mesh = ref.make_production_mesh(multi_pod=multi_pod)
    residual = "replicated" if cfg.family in ("ssm", "hybrid") else "seq"
    with (unrolled_scans() if unrolled else contextlib.nullcontext()):
        fn, specs, shardings = ref.build_case(cfg, shape, mesh, microbatches)
        t0 = time.perf_counter()
        with mesh, policy.activation_policy(mesh, residual=residual):
            lowered = jax.jit(fn, in_shardings=shardings).lower(*specs)
            t1 = time.perf_counter()
            compiled = lowered.compile()
            t2 = time.perf_counter()
    hlo = compiled.as_text()
    if hlo_path:
        with open(hlo_path, "w") as f:
            f.write(hlo)
    got = read_hlo(hlo, ref.collective_bytes)
    if unrolled and any(loop["trip_count"] for loop in got["while_loops"]):
        raise RuntimeError(f"loops left after unrolling: "
                           f"{got['while_loops']}")
    return {"mesh": "2x16x16" if multi_pod else "16x16",
            "devices": int(math.prod(mesh.shape.values())),
            "step_kind": shape.kind,
            "read": "unrolled" if unrolled else "scaled",
            "lower_seconds": round(t1 - t0, 2),
            "compile_seconds": round(t2 - t1, 2),
            **got,
            "memory": ref.memory_dict(compiled),
            "microbatches": microbatches,
            "residual": residual}


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             unrolled: bool = False, hlo_path: str | None = None) -> dict:
    """A named case as the reference's `run_case` picks its configuration
    (the long-context variant, its train microbatches)."""
    ref = reference()
    from repro.configs import INPUT_SHAPES, get_config
    shape = INPUT_SHAPES[shape_name]
    cfg = ref.variant_for_shape(get_config(arch), shape)
    mb = (ref.TRAIN_MICROBATCHES.get(arch, 1) if shape.kind == "train"
          else 1)
    rec = compile_case(ref, cfg, shape, multi_pod=multi_pod,
                       microbatches=mb, unrolled=unrolled, hlo_path=hlo_path)
    return {"arch": arch, "shape": shape_name, **rec,
            "long_context_variant": cfg.long_context_window is not None}


def record_path(out: str, arch: str, shape: str, multi_pod: bool) -> str:
    mesh = "2x16x16" if multi_pod else "16x16"
    return os.path.join(out, f"{arch}_{shape}_{mesh}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--out", default=None)
    ap.add_argument("--hlo", default=None,
                    help="also write the partitioned HLO text here")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--unrolled", action="store_true")
    args = ap.parse_args(argv)
    rec = run_case(args.arch, args.shape, multi_pod=args.multi_pod,
                   unrolled=args.unrolled, hlo_path=args.hlo)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(record_path(args.out, args.arch, args.shape,
                              args.multi_pod), "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
