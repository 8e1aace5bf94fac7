"""issue_ms.train: host ms per call of ``train.step`` (the port's tracer):
the time the host takes to enqueue one train step, over the window and
the traced units."""

from mdbench.spans import host_ms, instrument  # noqa: F401


def read(run):
    return host_ms(run, "train.step")
