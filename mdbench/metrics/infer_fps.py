"""infer_fps: frames completed per second over the whole window."""

from mdbench.readers import window_rate as read  # noqa: F401
