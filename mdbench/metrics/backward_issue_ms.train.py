"""backward_issue_ms.train: host ms per call of ``train.backward`` (the
port's tracer): the host's enqueue of ``backward()``, over the window and
the traced units."""

from mdbench.spans import host_ms, instrument  # noqa: F401


def read(run):
    return host_ms(run, "train.backward")
