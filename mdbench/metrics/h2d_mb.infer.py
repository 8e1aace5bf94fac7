"""h2d_mb.infer: MB put to the device per call of ``pipeline.as_batch``
(the port's tracer: the ``h2d_bytes`` counter over the calls of the
``pipeline.as_batch`` span), over the window and the traced units."""

from mdbench.spans import instrument, per_call  # noqa: F401


def read(run):
    n = per_call(run, "h2d_bytes", "pipeline.as_batch")
    return n / 1e6 if n is not None else None
