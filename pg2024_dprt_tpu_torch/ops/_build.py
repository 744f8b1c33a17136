"""Build and load the port's CUDA kernels.

Each source in csrc/ is compiled by nvcc for sm_90a into a shared library
with a plain C interface, in the gitignored directory
pg2024_dprt_tpu_torch/build/, at first use, and loaded with ctypes. The
sources include no PyTorch header, so a build takes seconds. Sources share
headers (csrc/*.cuh), so a library is rebuilt when any file of csrc/ is
newer than it. A build failure raises with nvcc's output; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

from ..utils.timing import span

_PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# library name -> CUDA source in csrc/
SOURCES = {"resident_trace": "resident_trace.cu", "frame": "frame.cu",
           "proxy_march": "proxy_march.cu", "proxy_mlp": "proxy_mlp.cu",
           "route": "route.cu", "pair_trace": "pair_trace.cu", "shade": "shade.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contracted multiply-adds: the kernels round like their plain
    # versions (grazing hits would otherwise flip)
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIBS: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """True when the library is missing or older than any file of csrc/
    (a changed shared header rebuilds every source that may include it)."""
    so = _so_path(name)
    if not os.path.exists(so):
        return True
    newest = max(os.path.getmtime(os.path.join(SRC_DIR, f))
                 for f in os.listdir(SRC_DIR))
    return os.path.getmtime(so) < newest


def build(names=None, force: bool = False) -> dict:
    """Compile the named sources (all by default), one nvcc per source, all
    started together. Returns {name: (seconds, ptxas report)}; raises
    RuntimeError with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if force or _stale(n)]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = f"{_so_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{out}")
            continue
        os.replace(tmp, _so_path(name))
        report[name] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if missing or older than the
    sources."""
    lib = _LIBS.get(name)
    if lib is None:
        with span("kernels.load"):
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(_so_path(name))
        _LIBS[name] = lib
    return lib
