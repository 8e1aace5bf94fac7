"""Tensor ops of the port, one module per JAX counterpart.

Importing this package registers the kernels' ``torch.library`` ops
(``movedepth::sweep_warp_corr`` and the rest, from ``sweep_warp`` and
``image_warp``): a process that loads an exported program
(``cli/export_model.py``) imports it before ``torch.export.load``.
"""

from movedepth_tpu_torch.ops import image_warp, sweep_warp

# the train path's kernel launch counters: kernel -> (module, attribute)
LAUNCH_COUNTERS = {"sweep_warp": (sweep_warp, "warp_launches"),
                   "sweep_warp_bwd": (sweep_warp, "warp_bwd_launches"),
                   "warp_images_border": (image_warp, "launches"),
                   "warp_images_border_coord_bwd": (image_warp,
                                                    "bwd_launches"),
                   "warp_images_border_l1": (image_warp, "l1_launches"),
                   "warp_images_border_l1_coord_bwd": (image_warp,
                                                       "l1_bwd_launches")}


def kernel_launches() -> dict:
    """The train path's CUDA kernel launches in this process, by kernel."""
    return {k: getattr(mod, name)
            for k, (mod, name) in LAUNCH_COUNTERS.items()}


def add_launches(counts: dict):
    """Add ``counts`` (by kernel, as :func:`kernel_launches` gives them)
    to the counters: the launches of a CUDA graph's replay, which runs no
    wrapper."""
    for k, (mod, name) in LAUNCH_COUNTERS.items():
        setattr(mod, name, getattr(mod, name) + counts[k])
