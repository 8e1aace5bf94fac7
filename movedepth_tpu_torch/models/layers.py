"""Reference-structure building blocks (port of
movedepth_tpu/models/layers.py), NCHW / NCDHW.

Attribute names follow the reference modules, so ``state_dict`` keys match
a reference checkpoint. BatchNorm is torch's own (eps 1e-5, momentum 0.1;
the JAX package's TorchBatchNorm reproduces it) and inference uses the
running statistics. The JAX package's subpixel fold and merged-head helpers
are TPU lane-padding schedules of these same functions and have no
counterpart here.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class Conv3x3(nn.Module):
    """Reflection-pad by one, then a 3x3 convolution."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x):
        return self.conv(self.pad(x))


class ConvBlock(nn.Module):
    """Conv3x3 (reflection padding) followed by ELU."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)
        self.nonlin = nn.ELU(inplace=True)

    def forward(self, x):
        return self.nonlin(self.conv(x))


class ConvBNReLU(nn.Module):
    """conv (no bias) -> BN -> ReLU with "same" padding: the FPN block."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding=kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)), inplace=True)


class ConvBnReLU3D(nn.Module):
    """3-D conv (no bias) -> BN -> ReLU over (B, C, D, H, W) volumes: 3x3x3
    with padding 1 unless ``kernel_size`` and ``padding`` say otherwise
    (Reg2D's (1, 3, 3) and (0, 1, 1))."""

    def __init__(self, in_channels, out_channels, stride=1, kernel_size=3,
                 padding=1):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm3d(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)), inplace=True)


def max_pool_3x3_s2(x):
    """MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)
