"""host_copy_ms.infer: host ms per batch of ``as_batch.host_copy``, the
NumPy copies of the host batch's arrays inside ``pipeline.as_batch`` (the
port's tracer: the copies' host ms over the calls of
``pipeline.as_batch``), over the window and the traced units."""

from mdbench.spans import host_ms, instrument  # noqa: F401


def read(run):
    return host_ms(run, "as_batch.host_copy", per="pipeline.as_batch")
