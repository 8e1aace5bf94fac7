"""train_eps: training examples stepped per second over the whole
window."""

from mdbench.readers import window_rate as read  # noqa: F401
