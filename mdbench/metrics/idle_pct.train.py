"""idle_pct.train: share of the traced window with no kernel, memcpy or
memset on the device (the union of the profiler's device intervals)."""

from mdbench.readers import idle_pct as read  # noqa: F401
