"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and may include the
shared headers ``csrc/*.cuh``. At first use it is compiled for Hopper
(``sm_90a``) into a shared library under ``build/movedepth_tpu_torch/`` at
the root of the checkout. The library's file name carries a hash of the
source, the headers and the flags, so an edited source rebuilds and an
unchanged one loads as it is. :func:`build_all` compiles several sources
at once, one nvcc process each. A source listed in ``UNITS`` is compiled
once per entry, each time with that entry's ``-D`` flags, as separate
translation units that nvcc builds in parallel, then linked into one
library.

The host data loader, ``csrc/loader.cpp``, is plain C++ and is built the
same way with the host compiler (``$CXX``, else ``g++``) by
:func:`build_loader`, in one of two routes: ``"a"`` decodes with libjpeg
and libpng, ``"b"`` (``-DMD_NO_CODECS``) leaves the decode to the caller,
for a host without their headers. :func:`loader_route` picks the route the
host supports.
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

# the JAX package's native/Makefile flags, so that on one host the port's
# loader and the JAX package's give the same bytes
LOADER_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
                "-shared")
# route -> (its -D flags, its libraries)
LOADER_ROUTES = {"a": ((), ("-ljpeg", "-lpng")),
                 "b": (("-DMD_NO_CODECS",), ())}

# name -> the -D flags of each translation unit of csrc/<name>.cu: the
# warp-correlate kernel's (C, G) instantiations, one unit per C beside the
# unit of its C interface
UNITS = {"sweep_warp_corr": [[]] + [[f"-DSWC_C={c}"] for c in (8, 16, 32, 64)]}

_libs: dict = {}
_routes: dict = {}  # compiler -> the loader route it supports
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
    key += repr(UNITS.get(name)).encode()
    return BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _start(args, suffix):
    """An nvcc process writing to a new temporary file under BUILD_DIR:
    (its path, the process)."""
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    return tmp, subprocess.Popen([nvcc(), *args, "-o", tmp],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build_all(names) -> None:
    """Compile every missing library of ``names`` in parallel: all nvcc
    processes (one per source, or per translation unit of a source in
    ``UNITS``) start together; a library of several units is linked once
    they are done. Raises if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, tmps = {}, []
    t0 = time.perf_counter()
    try:
        for name in todo:
            src = str(CSRC / f"{name}.cu")
            if name in UNITS:
                flags = [f for f in NVCC_FLAGS if f != "-shared"]
                jobs[name] = [_start([*flags, *unit, "-c", src], ".o")
                              for unit in UNITS[name]]
            else:
                jobs[name] = [_start([*NVCC_FLAGS, src], ".so")]
            tmps += [tmp for tmp, _ in jobs[name]]
        failed = []
        for name, units in jobs.items():
            errs = [proc.communicate()[1] for _, proc in units]
            bad = [err for (_, proc), err in zip(units, errs)
                   if proc.returncode != 0]
            if bad:
                failed += [f"nvcc failed on csrc/{name}.cu:\n{err}"
                           for err in bad]
                continue
            out = units[0][0]
            if name in UNITS:
                out, link = _start(["-shared", *(t for t, _ in units)],
                                   ".so")
                tmps.append(out)
                _, err = link.communicate()
                if link.returncode != 0:
                    failed.append(f"linking csrc/{name}.cu failed:\n{err}")
                    continue
            # atomic: a concurrent build never sees half a file
            os.replace(out, library_path(name))
            build_reports[name] = (time.perf_counter() - t0, "".join(errs))
    finally:
        for units in jobs.values():
            for _, proc in units:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for tmp in tmps:
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


def cxx() -> str:
    return os.environ.get("CXX") or "g++"


def loader_route() -> str:
    """``"a"`` where the host compiler finds ``jpeglib.h`` and ``png.h``,
    else ``"b"`` (asked once per compiler in a process)."""
    if cxx() not in _routes:
        _routes[cxx()] = _probe_codecs()
    return _routes[cxx()]


def _probe_codecs() -> str:
    probe = "#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"
    try:
        proc = subprocess.run([cxx(), "-x", "c++", "-E", "-", "-o",
                               os.devnull], input=probe, capture_output=True,
                              text=True, timeout=60)
    except OSError:  # no compiler: building either route will say so
        return "b"
    return "a" if proc.returncode == 0 else "b"


def loader_path(route: str) -> Path:
    """Where ``csrc/loader.cpp`` builds to in ``route`` under the current
    source, flags and compiler."""
    key = (CSRC / "loader.cpp").read_bytes()
    defines, libs = LOADER_ROUTES[route]
    key += " ".join((cxx(), *LOADER_FLAGS, *defines, *libs)).encode()
    return BUILD_DIR / (f"loader-{route}-"
                        f"{hashlib.sha256(key).hexdigest()[:16]}.so")


def build_loader(route: str) -> Path:
    """Compile ``csrc/loader.cpp`` in ``route`` if its library is missing
    and return the library's path; the seconds a build took go to
    ``build_reports["loader-<route>"]``. A build writes a temporary file
    and renames it, so processes racing on the first use are safe. Raises
    ``RuntimeError`` with the compiler's output if it fails."""
    out = loader_path(route)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    defines, libs = LOADER_ROUTES[route]
    cmd = [cxx(), *LOADER_FLAGS, *defines, "-o", tmp,
           str(CSRC / "loader.cpp"), *libs]
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except OSError as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:"
                               f"\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_reports[f"loader-{route}"] = (time.perf_counter() - t0,
                                        proc.stderr)
    return out
