"""Tensor ops of the port, one module per JAX counterpart.

Importing this package registers the kernels' ``torch.library`` ops
(``movedepth::sweep_warp_corr`` and the rest, from ``sweep_warp`` and
``image_warp``): a process that loads an exported program
(``cli/export_model.py``) imports it before ``torch.export.load``.
"""

from movedepth_tpu_torch import trace
from movedepth_tpu_torch.ops import image_warp, sweep_warp  # noqa: F401

# the train path's kernels; each wrapper counts ``launch.<kernel>``
TRAIN_KERNELS = ("sweep_warp", "sweep_warp_bwd", "warp_images_border",
                 "warp_images_border_coord_bwd", "warp_images_border_l1",
                 "warp_images_border_l1_coord_bwd")


def kernel_launches() -> dict:
    """The train path's CUDA kernel launches in this process (since the
    tracer's last reset), by kernel: a view of the tracer's counters."""
    return {k: trace.counter(f"launch.{k}") for k in TRAIN_KERNELS}
