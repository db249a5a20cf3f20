"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under `jacobiforcing_tpu_torch/csrc/` is compiled by `nvcc` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), placed in `build/kernels/` at the repository root under a
name keyed by a hash of the source, the shared headers (`csrc/*.cuh`) and the
flags.  A library that is already there is reused.  Nothing is built when
this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_many(names: Sequence[str]) -> Dict[str, float]:
    """Compile every csrc/<name>.cu that is not built yet, one `nvcc` per
    source, all started together.  Returns the seconds from each build's
    start until it was collected (0.0 for a library that was already there);
    raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    seconds = {name: 0.0 for name in names}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, path, tmp, proc, time.perf_counter()))
    failures = []
    for name, path, tmp, proc, t0 in running:
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless it is built already; returns the library."""
    build_many([name])
    return library_path(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
