"""Optimizer and train step of the port (port of movedepth_tpu/train)."""
