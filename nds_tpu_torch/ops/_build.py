"""Build the hand-written Hopper kernels of ops/csrc/ and load them.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into its own shared
library `_build/lib<name>.so` with a plain C interface, loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes). All sources
compile in parallel, one nvcc process each. A library is rebuilt when its
source or a shared header of csrc/ (`*.cuh`) is newer; the build writes to a temporary name and renames it into
place, so a concurrent loader never sees a half-written library.

Nothing here runs at import time: the first `load()` builds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs = {}  # name -> ctypes.CDLL, guarded by _lock


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found: the CUDA toolkit is required to "
                           "build the kernels in ops/csrc/")


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [f"{name}.cu"] + [f for f in os.listdir(CSRC) if f.endswith(".cuh")]
    newest = max(os.path.getmtime(os.path.join(CSRC, f)) for f in deps)
    return os.path.getmtime(lib) < newest


def build_all(names=None) -> dict:
    """Compile every stale source in parallel. Returns {name: seconds} for
    the sources compiled (an up-to-date library is not rebuilt). The ptxas
    report of each build is kept in _build/<name>.log."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = _lib_path(name) + f".tmp{os.getpid()}"
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, log)
    secs = {}
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        msgs = []
        for name in failed:
            with open(os.path.join(BUILD_DIR, f"{name}.log")) as f:
                msgs.append(f"--- {name}.cu ---\n{f.read()[-4000:]}")
        raise KernelBuildError("nvcc failed:\n" + "\n".join(msgs))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building every stale source on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
        return lib
