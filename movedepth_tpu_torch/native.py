"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and may include the
shared headers ``csrc/*.cuh``. At first use it is compiled for Hopper
(``sm_90a``) into a shared library under ``build/movedepth_tpu_torch/`` at
the root of the checkout. The library's file name carries a hash of the
source, the headers and the flags, so an edited source rebuilds and an
unchanged one loads as it is. :func:`build_all` compiles several sources
at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to under the current sources."""
    key = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        key += header.read_bytes()
    key += " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_all(names) -> None:
    """Compile every missing library of ``names`` in parallel: all nvcc
    processes start together. Raises if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    t0 = time.perf_counter()
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((name, tmp, proc))
        failed = []
        for name, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{name}.cu:\n{err}")
                continue
            # atomic: a concurrent build never sees half a file
            os.replace(tmp, library_path(name))
            build_reports[name] = (time.perf_counter() - t0, err)
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, signatures=None) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it.

    ``signatures`` maps a function name to its (argtypes, restype); they are
    set once, when this process first loads the library."""
    if name not in _libs:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in (signatures or {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return _libs[name]


def ptxas_report(name: str) -> list:
    """[(kernel, registers, stack bytes, spill-store bytes, static shared
    memory bytes)] for each kernel of this process's build of
    ``csrc/<name>.cu`` (empty if it was built before), from nvcc's
    ``-Xptxas -v`` report; kernel names demangled where the toolkit's
    ``cu++filt`` is at hand. Dynamic shared memory is set at launch and
    not in the report."""
    report = build_reports.get(name)
    rows, kernel, stack, spill = [], None, 0, 0
    for line in (report[1] if report else "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, stack, spill = m.group(1), 0, 0
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append([kernel, int(m.group(1)), stack, spill,
                         int(smem.group(1)) if smem else 0])
            kernel = None
    filt = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cu++filt")
    if rows and os.path.isfile(filt):
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for row, demangled in zip(rows, names):
                row[0] = demangled
    return [tuple(r) for r in rows]
