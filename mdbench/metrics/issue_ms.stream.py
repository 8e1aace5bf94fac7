"""issue_ms.stream: host ms per frame from the call of
``forward_infer_fused`` to its return, before the read-back: the time the
host takes to enqueue the forward, over the window."""

from mdbench.readers import mean_span


def read(run):
    return mean_span(run, "issue_ms")
