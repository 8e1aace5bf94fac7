"""forward_issue_ms.train: host ms per call of ``train.forward`` (the
port's tracer): the host's enqueue of ``forward_train`` and its losses,
over the window and the traced units."""

from mdbench.spans import host_ms, instrument  # noqa: F401


def read(run):
    return host_ms(run, "train.forward")
