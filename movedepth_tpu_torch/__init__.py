"""MoveDepth in PyTorch for NVIDIA Hopper: the port of ``movedepth_tpu``.

Module paths mirror the JAX package (``ops/costvolume.py`` here ports
``movedepth_tpu/ops/costvolume.py``). Models are ``nn.Module``s in NCHW
that keep the reference's ``state_dict`` key names, so a reference folder
of per-model ``.pth`` files loads unconverted. The public pipeline
functions keep the JAX package's NHWC batch layout and output keys.

The configuration dataclass is shared with the JAX package: its module
imports no JAX.
"""

from movedepth_tpu.config import Config

__all__ = ["Config"]
