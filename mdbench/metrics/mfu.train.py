"""mfu.train: model FLOPs (convolutions and matrix products, counted on
the reference at batch 1 and scaled) of the traced items over the traced
window, as a share of the card's dense bf16 peak."""

from mdbench.readers import mfu as read  # noqa: F401
