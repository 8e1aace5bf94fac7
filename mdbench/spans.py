"""What the port's own tracer (``movedepth_tpu_torch/trace.py``) saw in a
traced run: the per-layer metrics that read the program's spans and
counters share these functions.

A reader's ``instrument`` turns the tracer on for the traced run (set-up
is over by then, so its spans and counters cover the window and the
traced units). It times the host alone unless a reader of the cell reads
a span's device ms: CUDA events change the pace of a host-bound loop, and
with it what the harness's own device spans read in the same window. The
program's ``movedepth.*`` profiler ranges open only in the traced units,
where the profiler records. A reader's ``read`` takes per-call numbers
from the tracer's summary. A program without the tracer, or without the
span or counter a metric reads, gives None and raises nothing.
"""

from __future__ import annotations


def tracer():
    """The port's tracer module, or None where the program has none."""
    try:
        from movedepth_tpu_torch import trace
    except ImportError:
        return None
    return trace


def instrument(run, state, device=False):
    """Forget what set-up counted and turn the tracer on; ``device``: the
    spans record CUDA events, which any one reader of the cell asking for
    is enough for."""
    trace = tracer()
    if trace is not None:
        run.tracer_device = getattr(run, "tracer_device", False) or device
        trace.reset()
        trace.enable(device=run.tracer_device)


def summary(run):
    """The tracer's summary, taken once per run (it waits for the device);
    None without a tracer."""
    cached = getattr(run, "tracer_summary", None)
    if cached is None:
        trace = tracer()
        if trace is None:
            return None
        cached = run.tracer_summary = trace.summary()
    return cached


def _span(run, name):
    summ = summary(run)
    s = (summ or {}).get("spans", {}).get(name)
    return s if s and s["calls"] else None


def host_ms(run, name, per=None):
    """Host ms of span ``name`` per call of span ``per`` (of ``name``
    itself by default)."""
    s, p = _span(run, name), _span(run, per or name)
    return s["host_ms"] / p["calls"] if s and p else None


def device_ms(run, name):
    """Device ms per call of span ``name``, over the calls that recorded
    CUDA events."""
    s = _span(run, name)
    if not s or not s.get("device_calls") or s.get("device_ms") is None:
        return None
    return s["device_ms"] / s["device_calls"]


def per_call(run, counter, name):
    """Counter ``counter`` per call of span ``name``."""
    s = _span(run, name)
    n = ((summary(run) or {}).get("counters") or {}).get(counter)
    return n / s["calls"] if s and n is not None else None
