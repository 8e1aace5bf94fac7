"""stream_p95_ms: the 95th percentile of every frame's latency in the
window, from the call until its depth is on the host."""

from mdbench.readers import p95


def read(run):
    return p95(run.latencies_ms)
