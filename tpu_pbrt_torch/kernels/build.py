"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with
a plain C interface and loaded with ctypes. Nothing is built at import:
the first launch (or `build_all()`) compiles every source that has no
library yet, one `nvcc` per source, all started together. Libraries go
into the ignored `.torch_build/` directory at the repo root, named by a
hash of their source, so an edited kernel is never served from a stale
build. The `-Xptxas -v` report of each build (registers, shared memory,
spills) is kept beside its library as `<name>.ptxas.txt`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".torch_build")

#: kernel library name -> CUDA source in csrc/
SOURCES = {"flush": "flush.cu", "expand": "expand.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: kernel library name -> times this process compiled it (build_all); the
#: render service's warm-resubmit audit reads it (a warm job builds none)
BUILDS: Dict[str, int] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA kernels "
        "of tpu_pbrt_torch are built from csrc/ at first use"
    )


def lib_path(name: str) -> str:
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all() -> Dict[str, float]:
    """Compile every kernel library that is missing, in parallel.
    Returns {name: seconds} for the libraries built by this call (empty
    when all were present). Raises with nvcc's output on a failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: lib_path(n) for n in SOURCES if not os.path.exists(lib_path(n))}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        ), tmp, out)
    secs, errors = {}, []
    for name, (p, tmp, out) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        secs[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
            f.write(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log[-4000:]}")
        else:
            os.replace(tmp, out)
            BUILDS[name] = BUILDS.get(name, 0) + 1
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
