"""One run of one cell: set-up, the measured window, the traced units,
the comparison with the reference, and the result's line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``:

- ``mdbench/configs/<config>.json``: the configuration as it is run
  (``config``: the program's ``Config`` fields) with its source and what
  was assumed;
- ``mdbench/traffic/<traffic>.json``: the mix's parameters, read by the
  loop it names, ``mdbench/loops/<loop>.py``;
- ``mdbench/metrics/<metric>.py``: a reader ``read(run)`` that returns the
  metric's value or None, and optionally ``instrument(run, state)``,
  called before a traced window, which registers the spans it reads;
- ``mdbench/limits/<cell>.json``: the limit of each number that the
  comparison with the reference gives in that cell.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import resource
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded by a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "movedepth_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def manifest(root: Path = ROOT, dormant: bool = False):
    """BENCHMARK.json; with ``dormant``, the entries of the cells that
    ``mdbench/dormant/<cell>.json`` keeps out of it put back, as the tests
    that still drive those cells' loops need them."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    if dormant:
        for path in sorted((HERE / "dormant").glob("*.json")):
            with open(path) as f:
                for key, entries in json.load(f).items():
                    bench[key] = bench[key] + entries
    return bench


def cell_metrics(bench, cell: str, kind: str):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those that list it, and those without a list whose end-to-end
    metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        listed = m.get("workloads")
        if kind == "end_to_end":
            if m["name"] in e2e:
                out.append(m)
        elif (cell in listed) if listed is not None else m["moves"] in e2e:
            out.append(m)
    return out


class Run:
    """The state of one run that loops and metric readers share."""

    def __init__(self, bench, cell, seed, seconds, trace, device,
                 overrides=None, started=None):
        overrides = overrides or {}
        self.started = time.perf_counter() if started is None else started
        self.cell = next(w for w in bench["workloads"] if w["name"] == cell)
        conf = next(c for c in bench["configs"]
                    if c["name"] == self.cell["config"])
        with open(ROOT / conf["file"]) as f:
            self.config_file = json.load(f)
        with open(HERE / "traffic" / f"{self.cell['traffic']}.json") as f:
            self.traffic = dict(json.load(f), **overrides.get("traffic", {}))
        self.config = dict(self.config_file["config"],
                           **overrides.get("config", {}))
        # the reference reads the same numbers through a plain namespace
        self.ref_cfg = SimpleNamespace(**self.config)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.recording = False  # True while the measured window runs
        self.spans = {}  # name -> values in ms
        self.events = {}  # name -> [(start, end)] CUDA event pairs
        self.items = 0  # frames or examples completed in the window
        self.units = 0  # batches, steps or frames completed in the window
        self.latencies_ms = []
        self.window_s = None
        self.profile = None  # trace.summarize of the traced units
        self.traced_units = 0
        self.traced_items = 0
        self.flops_per_item = None
        self.notes = []

    def stage(self, label):
        """Note the seconds since the process started at a set-up stage."""
        self.notes.append(f"set-up, {label}: "
                          f"{time.perf_counter() - self.started:.2f} s")

    def log(self, msg):
        print(f"[mdbench] {msg}", file=sys.stderr, flush=True)

    def span(self, name, ms):
        if self.recording:
            self.spans.setdefault(name, []).append(ms)


def _limits(cell):
    path = HERE / "limits" / f"{cell}.json"
    if not path.is_file():
        return {}
    with open(path) as f:
        return json.load(f)["limits"]


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def judge(numbers, limits):
    """{name: {"value", "limit"}} of every number compared, and whether
    each lies at or under its limit. The cell's limits file names the
    numbers compared; without one, every number is shown with no limit
    and the run is not correct. A limited number that is missing fails."""
    names = list(limits) if limits else list(numbers)
    checks, ok = {}, bool(limits)
    for name in names:
        value, limit = numbers.get(name, math.inf), limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and _finite(value) and value <= limit
    return checks, ok


def run_cell(cell, seed, seconds, trace, device="cuda", overrides=None,
             control=False, started=None):
    """Run ``cell`` and return its result's line (a dict). ``control``
    puts the reference at fp8 in the program's place in the comparison
    (the readings that set a limit's upper end)."""
    import torch

    bench = manifest()
    run = Run(bench, cell, seed, seconds, trace, device, overrides, started)
    loop = load_module(HERE / "loops" / f"{run.traffic['loop']}.py",
                       f"mdbench_loop_{run.traffic['loop']}")
    wanted = cell_metrics(bench, cell, "per_layer" if trace
                          else "end_to_end")
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py",
                                      f"mdbench_metric_{m['name']}")
               for m in wanted if m["name"] != "setup_s"}
    cuda = torch.device(device).type == "cuda"

    state = loop.setup(run)
    if trace and cuda:
        for reader in readers.values():
            if hasattr(reader, "instrument"):
                reader.instrument(run, state)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.started

    # the measured window: whole units until the time is up
    host0 = host_reading()
    run.recording = True
    t0 = time.perf_counter()
    while True:
        loop.unit(run, state, run.units)
        run.units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    loop.drain(run, state)
    if cuda:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    run.recording = False
    run.notes.append(host_note(host0, host_reading()))
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    if trace and cuda:
        from mdbench import trace as T
        n = int(run.traffic["trace_units"])
        base = run.units
        run.profile = T.profile_units(
            lambda i: loop.unit(run, state, base + i), n,
            lambda: loop.drain(run, state))
        run.traced_units = n
        run.traced_items = n * int(run.traffic["batch"])

    numbers, attempted, failed = loop.compare(run, state, control)
    if trace:
        run.flops_per_item = loop.flops_per_item(run, state)
    checks, ok = judge(numbers, _limits(cell))
    ok = ok and failed == 0
    for name in sorted(set(numbers) - set(checks)):
        run.notes.append(f"reading {name} (not compared): {numbers[name]!r}")

    metrics = {}
    for m in wanted:
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_modules()
    for note in run.notes:
        run.log(note)
    result = {
        "correct": ok,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(cuda, peak, run),
    }
    if trace and run.profile is not None:
        result["breakdown"] = run.profile["breakdown"]
    result["checks"] = checks
    return result, bad


def device_info(cuda, peak, run):
    import torch
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(run.cell["chips"]), "memory_peak_bytes": int(peak)}
    if run.profile is not None:
        out["busy_s"] = run.profile["busy_s"]
        out["window_s"] = run.profile["window_s"]
    return out


def check_lines(checks):
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]


def card_report():
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def host_reading():
    """The process's page faults and context switches so far, and the
    host's load average: what the host did to a window, for the log."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"minor_faults": ru.ru_minflt, "major_faults": ru.ru_majflt,
            "involuntary_switches": ru.ru_nivcsw,
            "voluntary_switches": ru.ru_nvcsw,
            "cpu_s": round(ru.ru_utime + ru.ru_stime, 3),
            "load_1min": os.getloadavg()[0]}


def host_note(before, after):
    """One log line: the window's page faults and context switches, the
    load average at its start and end, and the CPUs the process may use."""
    counts = ", ".join(f"{k} {after[k] - before[k]:g}" for k in after
                       if k != "load_1min")
    return (f"window host: {counts}, load_1min {before['load_1min']:.2f} "
            f"-> {after['load_1min']:.2f}, cpus "
            f"{len(os.sched_getaffinity(0))} of {os.cpu_count()}")
