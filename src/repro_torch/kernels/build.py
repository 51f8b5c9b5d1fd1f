"""Build the CUDA sources under `csrc/` at first use and load them; and
`check_card`, the device check each wrapper makes before it launches.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface, loaded with ctypes. Libraries go to `_build/` beside this
file (listed in .gitignore), named by a hash of the sources and the flags,
so a changed source is rebuilt and an unchanged one is built once per
checkout. The compiler's output (`-Xptxas -v`: each kernel's registers and
spills) is kept beside each library, in `log_path(name)`. Nothing here runs
at import time: this module is imported on machines with no CUDA toolkit,
where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed by the bytes of every source
    under csrc/ (headers included) and the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output from building `library_path(name)`."""
    return library_path(name).with_suffix(".log")


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all `nvcc`
    processes started together, and wait for them. Raises RuntimeError
    with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in names}
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        log_path(name).write_text(log)
        os.replace(tmp, lib)         # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, built first if needed."""
    return ctypes.CDLL(str(build(name)[name]))


def check_card(op: str, t) -> None:
    """Raise unless `t` lies on the current CUDA device: a wrapper's kernel
    launches on the current device's stream only."""
    import torch
    if t.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu, not {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{op} inputs lie on {t.device}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
