"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for Hopper (``sm_90a``) into a shared library under
``build/movedepth_tpu_torch/`` at the root of the checkout. The library's
file name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "movedepth_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
# name -> (build seconds, nvcc's -Xptxas -v report) for builds in this process
build_reports: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    key = src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    so = BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
        build_reports[name] = (time.perf_counter() - t0, proc.stderr)
    _libs[name] = ctypes.CDLL(str(so))
    return _libs[name]
