"""ctypes bridge to the native C++ SAH BVH builder (csrc/bvh_builder.cpp).

A copy of tpu_pbrt/accel/native.py: the same C++ source, compiled once by
g++ into the ignored `.torch_build/` directory at the repo root and loaded
through ctypes (plain C ABI with caller-allocated numpy buffers). Using
the same builder as the JAX package keeps the port's BVH, treelet cut and
leaf order identical to the reference's.

Graceful degradation: if g++ or the compile is unavailable the callers
fall back to the pure-numpy builders in accel/build.py."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
_OUT_DIR = os.path.join(os.path.dirname(_PKG), ".torch_build")
_LIB = os.path.join(_OUT_DIR, "libbvh_builder.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    os.makedirs(_OUT_DIR, exist_ok=True)
    # rebuild when the source is newer than the cached .so
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return True
    # build under a per-process name and rename into place, so concurrent
    # test workers never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode == 0:
        os.replace(tmp, _LIB)
    if r.returncode != 0:
        from tpu_pbrt_torch.utils.error import Warning as _W

        _W(f"native build failed ({r.stderr.decode()[:200]}); using numpy builders")
        return False
    return True


def get_lib():
    """The loaded native library, or None (numpy fallback)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC) or not _compile():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.build_sah_bvh.restype = ctypes.c_int64
        lib.build_sah_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # bmin
            ctypes.POINTER(ctypes.c_double),  # bmax
            ctypes.c_int64,  # n
            ctypes.c_int32,  # max_leaf
            ctypes.POINTER(ctypes.c_float),  # out_min
            ctypes.POINTER(ctypes.c_float),  # out_max
            ctypes.POINTER(ctypes.c_int32),  # out_prim_off
            ctypes.POINTER(ctypes.c_int32),  # out_nprims
            ctypes.POINTER(ctypes.c_int32),  # out_second
            ctypes.POINTER(ctypes.c_int32),  # out_axis
            ctypes.POINTER(ctypes.c_int64),  # out_order
        ]
        _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_build_sah(bmin: np.ndarray, bmax: np.ndarray, max_leaf: int):
    """Run the native SAH build; returns BVHArrays or None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from tpu_pbrt_torch.accel.build import BVHArrays

    n = len(bmin)
    bmin = np.ascontiguousarray(bmin, np.float64)
    bmax = np.ascontiguousarray(bmax, np.float64)
    cap = 2 * n + 1
    out_min = np.empty((cap, 3), np.float32)
    out_max = np.empty((cap, 3), np.float32)
    out_prim_off = np.zeros(cap, np.int32)
    out_nprims = np.zeros(cap, np.int32)
    out_second = np.zeros(cap, np.int32)
    out_axis = np.zeros(cap, np.int32)
    out_order = np.empty(n, np.int64)
    m = lib.build_sah_bvh(
        _ptr(bmin, ctypes.c_double),
        _ptr(bmax, ctypes.c_double),
        ctypes.c_int64(n),
        ctypes.c_int32(max_leaf),
        _ptr(out_min, ctypes.c_float),
        _ptr(out_max, ctypes.c_float),
        _ptr(out_prim_off, ctypes.c_int32),
        _ptr(out_nprims, ctypes.c_int32),
        _ptr(out_second, ctypes.c_int32),
        _ptr(out_axis, ctypes.c_int32),
        _ptr(out_order, ctypes.c_int64),
    )
    if m <= 0:
        return None
    return BVHArrays(
        bounds_min=out_min[:m].copy(),
        bounds_max=out_max[:m].copy(),
        prim_offset=out_prim_off[:m].copy(),
        n_prims=out_nprims[:m].copy(),
        second_child=out_second[:m].copy(),
        axis=out_axis[:m].copy(),
        prim_order=out_order,
    )
