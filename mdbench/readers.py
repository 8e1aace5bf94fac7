"""Arithmetic shared by the metric readers under ``mdbench/metrics/``:
rates and tails over the window, spans, and the traced units' device
time, idle share, roofline and model FLOP shares."""

from __future__ import annotations

import math
import re

from mdbench import work


def p95(values):
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it. None without values."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]


def window_rate(run):
    """Items (frames or examples) completed per second of the window."""
    return run.items / run.window_s if run.items else None


def mean_span(run, name):
    vals = run.spans.get(name)
    return sum(vals) / len(vals) if vals else None


def idle_pct(run):
    """Share of the traced window in which no kernel, memcpy or memset ran
    on the device."""
    prof = run.profile
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu(run):
    """Model FLOPs of the traced items over the traced window, as a share
    of the card's dense bf16 peak."""
    prof = run.profile
    if not prof or not run.flops_per_item:
        return None
    rate = run.flops_per_item * run.traced_items / prof["window_s"]
    return 100.0 * rate / work.BF16_FLOPS


def kernel_seconds(run, pattern):
    """Device seconds of the traced kernels whose name matches the regular
    expression, and their count."""
    prog = re.compile(pattern)
    hits = [s for name, s in (run.profile or {}).get("kernels", [])
            if prog.search(name)]
    return sum(hits), len(hits)


def roofline(run, parts):
    """Sum of the bound over the sum of device time of the traced calls of
    ``parts``: [(kernel name pattern, calls per unit, bound ms per call)].
    None when any part's kernels are missing from the trace."""
    bound = spent = 0.0
    for pattern, calls, ms in parts:
        seconds, n = kernel_seconds(run, pattern)
        if n == 0 or seconds <= 0:
            return None
        spent += seconds
        bound += ms * 1e-3 * calls * run.traced_units
    return 100.0 * bound / spent


def event_span(run, name, first, last, start_hook="forward_pre",
               end_hook="forward"):
    """Record CUDA events on the device from ``first``'s start hook to
    ``last``'s end hook, in the measured window only, under ``name``.
    Modules take forward hooks; an optimizer takes step hooks
    (``start_hook="step_pre"``, ``end_hook="step_post"``)."""
    import torch
    pairs = run.events.setdefault(name, [])
    open_ = {}

    def start(*_):
        if run.recording:
            open_["event"] = torch.cuda.Event(enable_timing=True)
            open_["event"].record()

    def end(*_):
        if run.recording and "event" in open_:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            pairs.append((open_.pop("event"), stop))

    getattr(first, f"register_{start_hook}_hook")(start)
    getattr(last, f"register_{end_hook}_hook")(end)


def mean_event_ms(run, name):
    """Mean device ms of the event pairs under ``name`` (after the window's
    synchronization)."""
    pairs = run.events.get(name)
    if not pairs:
        return None
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)
