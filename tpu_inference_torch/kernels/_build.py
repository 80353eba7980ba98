"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so``, a shared library with a plain C
interface loaded through ``ctypes``. The hash covers the source and the
flags, so an edited source rebuilds and an unchanged one loads the
library already there. Nothing builds at import: the first launch on a
CUDA tensor (or ``build_all``) builds. There is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build (0.0 when an existing build loaded).
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str | None:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    return next((c for c in cands if os.path.isfile(c)), None)


def _lib_path(name: str) -> str:
    """Build output path, keyed by the source, the shared headers in
    csrc/ and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str) -> tuple:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build kernel {name!r}: nvcc not found (set CUDA_HOME "
            "or put nvcc on PATH); the port has no fallback for CUDA "
            "tensors")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _lib_path(name)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: str, out: str, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    with open(out + ".log", "w") as f:      # ptxas register/smem report
        f.write(log)


def build_all(names: List[str]) -> Dict[str, float]:
    """Build every named library not built yet, all nvcc processes
    started together; returns {name: build seconds}."""
    with _lock:
        t0 = time.perf_counter()
        started = []
        for name in names:
            if name in _libs or os.path.exists(_lib_path(name)):
                build_seconds.setdefault(name, 0.0)
                continue
            started.append((name, *_start_build(name)))
        errors = []
        for name, proc, tmp, out in started:     # wait for every nvcc
            try:
                _finish_build(name, proc, tmp, out, t0)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]
        return {n: build_seconds[n] for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first when
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err}:"
                           f" {msg})")
