"""ctypes binding for the native C++ BVH builder (native/bvh_builder.cpp).

The same C++ source as the JAX package's builder, compiled on first use into
the port's own gitignored build directory (pg2024_dprt_tpu_torch/build/);
falls back to the pure-python builder when g++ is unavailable. The two
builders may cut different trees, so tests that compare the packages'
cluster tables check that both packages took the same builder.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False

_PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SO = os.path.join(_PKG, "build", "libbvh_builder.so")
_SRC = os.path.join(os.path.dirname(_PKG), "native", "bvh_builder.cpp")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            # build under a private name and rename: concurrent test workers
            # must never load a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.bvh_build.restype = ctypes.c_int32
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # v0
            ctypes.POINTER(ctypes.c_float),  # v1
            ctypes.POINTER(ctypes.c_float),  # v2
            ctypes.c_int32,                  # num_tris
            ctypes.c_int32,                  # max_leaf
            ctypes.POINTER(ctypes.c_float),  # bounds_min
            ctypes.POINTER(ctypes.c_float),  # bounds_max
            ctypes.POINTER(ctypes.c_int32),  # first
            ctypes.POINTER(ctypes.c_int32),  # count
            ctypes.POINTER(ctypes.c_int32),  # skip
            ctypes.POINTER(ctypes.c_int32),  # tri_order
        ]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, max_leaf: int = 4):
    """Native build; returns a FlatBVH or None if the library is unavailable."""
    from .bvh import FlatBVH

    lib = _load()
    if lib is None:
        return None
    t = v0.shape[0]
    if t == 0:
        return None  # python handles the degenerate case

    cap = 2 * t
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    first = np.empty((cap,), np.int32)
    count = np.empty((cap,), np.int32)
    skip = np.empty((cap,), np.int32)
    tri_order = np.empty((t,), np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    arr = lambda a: a.ctypes.data_as(fp)
    iarr = lambda a: a.ctypes.data_as(ip)

    v0c = np.ascontiguousarray(v0, np.float32)
    v1c = np.ascontiguousarray(v1, np.float32)
    v2c = np.ascontiguousarray(v2, np.float32)

    m = lib.bvh_build(
        arr(v0c), arr(v1c), arr(v2c), t, max_leaf,
        arr(bmin), arr(bmax), iarr(first), iarr(count), iarr(skip), iarr(tri_order),
    )
    if m <= 0:
        return None
    return FlatBVH(
        bounds_min=bmin[:m].copy(),
        bounds_max=bmax[:m].copy(),
        first=first[:m].copy(),
        count=count[:m].copy(),
        skip=skip[:m].copy(),
        tri_order=tri_order,
    )
