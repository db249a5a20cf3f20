"""Build the port's native code at first use and load it with ctypes.

Each CUDA source under `jacobiforcing_tpu_torch/csrc/` (`*.cu`) is compiled by
`nvcc` into a shared library with a plain C interface (no PyTorch headers, so
a build takes seconds), placed in `build/kernels/` at the repository root
under a name keyed by a hash of the source, the shared headers (`csrc/*.cuh`)
and the flags.  Host C++ sources (`*.cpp`: the native block manager) take the
host compiler (`$CXX`, else `c++`) into `build/host/`, keyed the same way by
the source, the compiler and its flags (`build_host`).  A library that is
already there is reused; every build writes a temporary file and renames it
into place, so processes that build the same library at once do not clash.
Nothing is built when this module is imported.
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
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
HOST_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-Wall"]
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


def host_compiler() -> str:
    return os.environ.get("CXX") or "c++"


def host_library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join([host_compiler(), *HOST_FLAGS]).encode())
    return HOST_BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with the host compiler unless it is built
    already; returns the library.  Raises RuntimeError if the compiler is
    missing or fails."""
    path = host_library_path(name)
    if path.exists():
        return path
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {name}.cpp failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name}.cpp failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cpp, building it first if needed."""
    with _LOCK:
        key = f"host:{name}"
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name)))
            _LIBS[key] = lib
        return lib
