"""MoveDepth in PyTorch for NVIDIA Hopper: the port of ``movedepth_tpu``.

Module paths mirror the JAX package (``ops/costvolume.py`` here ports
``movedepth_tpu/ops/costvolume.py``). Models are ``nn.Module``s in NCHW
that keep the reference's ``state_dict`` key names, so a reference folder
of per-model ``.pth`` files loads unconverted. The public pipeline
functions keep the JAX package's NHWC batch layout and output keys.

The port imports nothing of the JAX package: ``config.py``,
``cli/options.py`` and the ``data/`` modules are its own copies, and an
``opt.json`` written by either package loads in the other.
"""

from movedepth_tpu_torch.config import Config

__all__ = ["Config"]
