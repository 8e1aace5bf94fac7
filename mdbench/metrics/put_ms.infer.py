"""put_ms.infer: host ms per batch of ``pipeline.as_batch``, the copy of
the host batch to the device, over the window."""

from mdbench.readers import mean_span


def read(run):
    return mean_span(run, "put_ms")
