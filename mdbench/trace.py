"""The profiler's view of a run: a few units of work traced by
``torch.profiler`` after the measured window, reduced to the device's busy
time, its idle gaps, the kernels that ran and what the host did meanwhile.

The traced units run between two synchronizations inside one host span,
``mdbench.profiled``; that span is the traced window. Busy time is the
union of the device's kernel, memcpy and memset intervals inside it.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "mdbench.profiled"
TOP = 10


def merged(intervals, lo, hi):
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy, lo, hi):
    """The idle intervals of [lo, hi] between the merged busy ones."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def _host_label(events, t):
    """What the host was doing at time t (us): the harness's innermost
    ``mdbench.*`` span and the outermost operator under way."""
    phase, op = None, None
    for ev in events:
        if not ev["ts"] <= t < ev["ts"] + ev["dur"]:
            continue
        name = ev["name"]
        if ev["cat"] == "user_annotation" and name.startswith("mdbench.") \
                and name != WINDOW:
            if phase is None or ev["dur"] < phase[1]:
                phase = (name, ev["dur"])
        elif ev["cat"] == "cpu_op":
            if op is None or ev["dur"] > op[1]:
                op = (name, ev["dur"])
    return "/".join(x[0] for x in (phase, op) if x) or "host"


def summarize(events):
    """Reduce chrome-trace events (dicts with cat, name, ts, dur in us) to
    the traced window's numbers, in seconds: ``window_s``, ``busy_s``,
    ``kernels`` [(name, s)] of every device interval in the window, and
    the ``breakdown`` of the result's line. None without a window span."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == WINDOW]
    if not spans:
        return None
    lo = spans[0]["ts"]
    hi = lo + spans[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = merged([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
            and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": [(e["name"], e["dur"] * 1e-6) for e in dev
                    if e["cat"] == "kernel"],
        "breakdown": {
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": [[_host_label(host, (s + e) / 2), (e - s) * 1e-6]
                          for s, e in idle]},
    }


def profile_units(unit, n, drain):
    """Run ``unit(i)`` for i < n under ``torch.profiler`` (CPU and CUDA
    activity) between two synchronizations in the window span, then
    ``drain()``; return :func:`summarize` of the trace. The trace goes
    through a file in the temporary directory, removed after reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function(WINDOW):
            for i in range(n):
                unit(i)
            drain()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="mdbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    for e in events:
        e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
    return summarize(events)
