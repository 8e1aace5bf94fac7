"""The port's tracer: spans at the layer boundaries and counters of the
work done there.

``span(name)`` is a context manager around one phase of the program::

    with trace.span("train.backward"):
        total.backward()

and ``traced(name)`` decorates a function with a span around each call.
Off, the default, ``span`` checks one module-level flag and returns one
shared object that does nothing. On (:func:`enable`), each span records
its host start and end (``time.perf_counter_ns``) and its parent (the
span open around it, in any thread: the recompute of a rematerialized
forward, which runs inside ``backward()``, lands under the span around
``backward()``). With ``enable(device=True)`` (the default) it also
records a pair of timing CUDA events on the current stream where the
process uses CUDA; ``enable(device=False)`` times the host alone, for a
host-bound loop whose pace the events would change. While a profiler
records (``torch.profiler``), each span also opens a
``torch.profiler.record_function`` range named ``movedepth.<name>``, so
that the trace shows the program's phases on its own clock beside the
device's kernels and copies; with no profiler running the span opens no
range. A span records no events while the current stream captures a CUDA
graph, and does nothing at all while ``torch.export`` or
``torch.compile`` traces.

``count(name, n)`` adds ``n`` to a counter. Counters are always on: the
kernel wrappers count their launches as ``launch.<kernel>``.

:func:`summary` waits for the device and returns per span name its calls,
host ms (total and max), self host ms (the host ms its child spans do not
cover), device ms (total, over the ``device_calls`` calls that recorded
events) and the names of its parents, and every counter. Finished event
pairs are folded into per-name sums as they complete, so a long run holds
only the pairs the device has not reached yet. :func:`reset` clears spans
and counters.
"""

from __future__ import annotations

import functools
import time

import torch

_on = False  # the one flag an off span checks
_device = True  # an on span records CUDA events
# whether a profiler records on this thread (then a span opens a range)
_profiling = torch.autograd._profiler_enabled

# the pending event pairs are polled each time this many more wait
_FOLD_EVERY = 256


class _Off:
    """The span of an off tracer: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Stats:
    __slots__ = ("calls", "host_ns", "max_ns", "self_ns", "device_ms",
                 "device_calls", "parents")

    def __init__(self):
        self.calls = self.host_ns = self.max_ns = self.self_ns = 0
        self.device_ms = 0.0
        self.device_calls = 0
        self.parents = set()


_stats: dict = {}  # span name -> _Stats
_counters: dict = {}  # counter name -> int
_open: list = []  # the spans open now, innermost last
_pending: list = []  # (name, start event, end event) not yet folded
_fold_at = _FOLD_EVERY  # poll when _pending reaches this length


class _Span:
    __slots__ = ("name", "parent", "t0", "child_ns", "range", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self)
        self.child_ns = 0
        self.range = None
        if _profiling():
            self.range = torch.profiler.record_function(
                "movedepth." + self.name)
            self.range.__enter__()
        self.start = None
        if (_device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.start is not None \
                and not torch.cuda.is_current_stream_capturing():
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _pending.append((self.name, self.start, end))
            if len(_pending) >= _fold_at:
                _fold(wait=False)
        if self.range is not None:
            self.range.__exit__(*exc)
        # the innermost open span is this one unless another thread's
        # span is open inside it; take this one out wherever it is
        for i in range(len(_open) - 1, -1, -1):
            if _open[i] is self:
                del _open[i]
                break
        st = _stats.get(self.name)
        if st is None:
            st = _stats[self.name] = _Stats()
        st.calls += 1
        st.host_ns += ns
        st.max_ns = max(st.max_ns, ns)
        st.self_ns += ns - self.child_ns
        if self.parent is not None:
            self.parent.child_ns += ns
            st.parents.add(self.parent.name)
        else:
            st.parents.add(None)
        return False


def span(name: str):
    """A span named ``name`` (a context manager); the shared no-op while
    the tracer is off or ``torch.export``/``torch.compile`` traces."""
    if not _on or torch.compiler.is_compiling():
        return OFF
    return _Span(name)


def traced(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` (always on)."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` (0 if nothing counted it)."""
    return _counters.get(name, 0)


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counters)


def enable(device: bool = True):
    """Turn the tracer on; ``device``: each span also records a pair of
    CUDA events (its device ms), else it times the host alone."""
    global _on, _device
    _on, _device = True, device


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Forget every span and counter (the tracer stays on or off)."""
    _stats.clear()
    _counters.clear()
    _pending.clear()
    _fold(wait=True)  # resets the polling length


def _fold(wait: bool):
    """Fold the pending event pairs whose end the device has reached into
    their span's device ms; ``wait``: all of them (after a synchronize)."""
    global _fold_at
    keep = []
    for name, start, end in _pending:
        if wait or end.query():
            st = _stats.get(name)
            if st is not None:
                st.device_ms += start.elapsed_time(end)
                st.device_calls += 1
        else:
            keep.append((name, start, end))
    _pending[:] = keep
    _fold_at = len(keep) + _FOLD_EVERY


def summary() -> dict:
    """{"spans": {name: {calls, host_ms, host_max_ms, self_host_ms,
    device_ms, device_calls, parents}}, "counters": {name: n}}. Waits for
    the device first; ``device_ms`` is None for a span that recorded no
    events (no CUDA in the process, ``enable(device=False)``, or only
    under a capture); a top-level span's parents hold None."""
    if _pending:
        torch.cuda.synchronize()
        _fold(wait=True)
    spans = {}
    for name, st in _stats.items():
        spans[name] = {
            "calls": st.calls,
            "host_ms": st.host_ns * 1e-6,
            "host_max_ms": st.max_ns * 1e-6,
            "self_host_ms": st.self_ns * 1e-6,
            "device_ms": st.device_ms if st.device_calls else None,
            "device_calls": st.device_calls,
            "parents": sorted(st.parents, key=lambda p: (p is not None, p)),
        }
    return {"spans": spans, "counters": dict(_counters)}
