"""Repository-level pytest hooks, loaded before the test workers start.

The JAX package's native loader binding (``movedepth_tpu/data/
native_loader.py``) runs ``make`` in ``native/`` from every process that
asks whether the library is available, and ``tests/test_native_loader.py``
asks at collection. Under ``pytest -n N`` on a tree without
``native/libmdloader.so`` the N workers then compile the same file at
once, and a worker that loads a half-written library skips its native
tests for the rest of the run. This hook builds the library once, in the
controlling process, before any worker collects; each worker's own
``make`` is then a timestamp no-op. A failing ``make`` (no compiler, no
libjpeg) is ignored, so such a host still skips those tests as before.
"""

import fcntl
import os
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native")
LOCK_FILE = os.path.join(NATIVE_DIR, ".libmdloader.lock")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the build is done
        return
    if not os.path.isfile(os.path.join(NATIVE_DIR, "Makefile")):
        return
    with open(LOCK_FILE, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build per tree at a time
        subprocess.run(["make", "-s", "libmdloader.so"], cwd=NATIVE_DIR,
                       capture_output=True, check=False)
