"""MVS matching encoders (FPN4, the cascade FPN3cas) and cost-volume
regularizers (port of movedepth_tpu/models/fpn.py), in the reference's
module structure."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from movedepth_tpu_torch.models.layers import ConvBNReLU, ConvBnReLU3D
from movedepth_tpu_torch.ops.deform import deform_conv2d
from movedepth_tpu_torch.ops.sampling import resize_bilinear


def _up2(x):
    """F.interpolate(scale_factor=2, bilinear, align_corners=True)."""
    return resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2),
                           align_corners=True)


def _add_trunk(module, bc):
    """The FPNs' four ConvBNReLU stages ``conv0``-``conv3`` (strides 1, 2,
    4 and 8; base ``bc`` channels times 1, 2, 4 and 8) on ``module``."""
    module.conv0 = nn.Sequential(ConvBNReLU(3, bc, 3), ConvBNReLU(bc, bc, 3))

    def stage(cin, cout):
        return nn.Sequential(ConvBNReLU(cin, cout, 5, 2),
                             ConvBNReLU(cout, cout, 3),
                             ConvBNReLU(cout, cout, 3))

    module.conv1 = stage(bc, bc * 2)
    module.conv2 = stage(bc * 2, bc * 4)
    module.conv3 = stage(bc * 4, bc * 8)


class FPN4(nn.Module):
    """4-stage FPN over NCHW images -> (matching feature, context feature).

    At ``scale`` s the matching feature has base*{3: 8, 2: 4, 1: 2, 0: 1}
    channels at 1/2^s resolution and the context feature is the stride-2^s
    trunk (conv2 at the shipped s=2). With ``dcn`` (below scale 3, as in
    the JAX package) the matching feature goes through three
    :class:`DCNConv2d` blocks, ``out_dcn_0`` and ``out_dcn_1`` with BN and
    ReLU, ``out_dcn_2`` without either.
    """

    def __init__(self, base_channels=8, scale=2, dcn=False):
        super().__init__()
        bc = base_channels
        self.scale = scale
        self.dcn = dcn
        _add_trunk(self, bc)
        final = bc * 8
        if scale < 3:
            self.inner1 = nn.Conv2d(bc * 4, final, 1, bias=True)
        if scale < 2:
            self.inner2 = nn.Conv2d(bc * 2, final, 1, bias=True)
        if scale < 1:
            self.inner3 = nn.Conv2d(bc, final, 1, bias=True)
        if scale == 3:
            self.out = nn.Conv2d(final, bc * 8, 1, bias=False)
        else:
            out_ch = {2: bc * 4, 1: bc * 2, 0: bc}[scale]
            self.out = nn.Conv2d(final, out_ch, 3, padding=1, bias=False)
            if dcn:  # the deformable refinement of the matching feature
                self.out_dcn_0 = DCNConv2d(out_ch, out_ch)
                self.out_dcn_1 = DCNConv2d(out_ch, out_ch)
                self.out_dcn_2 = DCNConv2d(out_ch, out_ch, relu=False,
                                           use_bn=False)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        conv3 = self.conv3(conv2)
        intra = conv3
        if self.scale < 3:
            intra = _up2(intra) + self.inner1(conv2)
        if self.scale < 2:
            intra = _up2(intra) + self.inner2(conv1)
        if self.scale < 1:
            intra = _up2(intra) + self.inner3(conv0)
        ctx = {3: conv3, 2: conv2, 1: conv1, 0: conv0}[self.scale]
        out = self.out(intra)
        if self.dcn and self.scale < 3:
            out = self.out_dcn_2(self.out_dcn_1(self.out_dcn_0(out)))
        return out, ctx


class FPN3cas(nn.Module):
    """The cascade FPN: FPN4's trunk with every lateral -> matching
    features at 1/4, 1/2 and 1/1 resolution with base*4, base*2 and base
    channels (``out1``-``out3``)."""

    def __init__(self, base_channels=8):
        super().__init__()
        bc = base_channels
        _add_trunk(self, bc)
        final = bc * 8
        self.inner1 = nn.Conv2d(bc * 4, final, 1, bias=True)
        self.inner2 = nn.Conv2d(bc * 2, final, 1, bias=True)
        self.inner3 = nn.Conv2d(bc, final, 1, bias=True)
        self.out1 = nn.Conv2d(final, bc * 4, 3, padding=1, bias=False)
        self.out2 = nn.Conv2d(final, bc * 2, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(final, bc, 3, padding=1, bias=False)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        conv3 = self.conv3(conv2)
        intra = _up2(conv3) + self.inner1(conv2)
        out1 = self.out1(intra)
        intra = _up2(intra) + self.inner2(conv1)
        out2 = self.out2(intra)
        intra = _up2(intra) + self.inner3(conv0)
        return [out1, out2, self.out3(intra)]


class Reg3D(nn.Module):
    """3-D U-Net cost regularizer: (B, G, D, H, W) -> (B, D, H, W) logits.

    Three stride-2 ConvBnReLU3D stages, ConvTranspose3d decoders with
    output_padding 1 and additive skips, a 1-channel prob head.
    """

    def __init__(self, base_channels=16):
        super().__init__()
        c = base_channels
        self.conv0 = ConvBnReLU3D(c, c)
        self.conv1 = ConvBnReLU3D(c, c * 2, stride=2)
        self.conv2 = ConvBnReLU3D(c * 2, c * 2)
        self.conv3 = ConvBnReLU3D(c * 2, c * 4, stride=2)
        self.conv4 = ConvBnReLU3D(c * 4, c * 4)
        self.conv5 = ConvBnReLU3D(c * 4, c * 8, stride=2)
        self.conv6 = ConvBnReLU3D(c * 8, c * 8)

        def up(cin, cout):
            return nn.Sequential(
                nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                   output_padding=1, bias=False),
                nn.BatchNorm3d(cout), nn.ReLU(inplace=True))

        self.conv7 = up(c * 8, c * 4)
        self.conv9 = up(c * 4, c * 2)
        self.conv11 = up(c * 2, c)
        self.prob = nn.Conv3d(c, 1, 3, stride=1, padding=1, bias=False)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)[:, 0]


class Reg2D(nn.Module):
    """The cost regularizer for few depth bins (fewer than 8): Reg3D's
    U-Net with (1, 3, 3) kernels, strides (1, 2, 2) and paddings (0, 1, 1),
    so the depth axis is never downsampled; the ConvTranspose3d decoders
    have output_padding (0, 1, 1). Its 1x1x1 prob head has a bias (Reg3D's
    has none).

    The reference hardcodes that head as ``Conv3d(8, 1, 1)``: 8 input
    channels whatever ``base_channels`` is, so it runs only at
    ``base_channels=8``. The JAX package's flax conv takes its input
    channels from the volume, ``base_channels``, and so does this port.
    """

    def __init__(self, base_channels=16):
        super().__init__()
        c = base_channels

        def blk(cin, cout, stride=1):
            return ConvBnReLU3D(cin, cout, (1, stride, stride), (1, 3, 3),
                                (0, 1, 1))

        def up(cin, cout):
            return nn.Sequential(
                nn.ConvTranspose3d(cin, cout, (1, 3, 3), stride=(1, 2, 2),
                                   padding=(0, 1, 1),
                                   output_padding=(0, 1, 1), bias=False),
                nn.BatchNorm3d(cout), nn.ReLU(inplace=True))

        self.conv0 = blk(c, c)
        self.conv1 = blk(c, c * 2, 2)
        self.conv2 = blk(c * 2, c * 2)
        self.conv3 = blk(c * 2, c * 4, 2)
        self.conv4 = blk(c * 4, c * 4)
        self.conv5 = blk(c * 4, c * 8, 2)
        self.conv6 = blk(c * 8, c * 8)
        self.conv7 = up(c * 8, c * 4)
        self.conv9 = up(c * 4, c * 2)
        self.conv11 = up(c * 2, c)
        self.prob = nn.Conv3d(c, 1, 1, bias=True)

    forward = Reg3D.forward  # the same skips and head


class DCNConv2d(nn.Module):
    """Modulated deformable conv block (DCNv2; port of the JAX package's
    ``DCNConv2d``, the reference's optional ``--dcn`` head): ``conv_offset``
    predicts 3*K*K channels from the input, the first 2*K*K the per-tap
    (dy, dx) offsets and a sigmoid of the rest the gates; then
    :func:`ops.deform.deform_conv2d` with ``weight`` (no bias), then BN and
    ReLU unless ``use_bn`` / ``relu`` is off. ``conv_offset`` starts at
    zero, so the block starts as a plain conv.

    State-dict keys follow the reference's modulated deformable conv:
    ``conv_offset.weight``, ``conv_offset.bias``, then the conv's own
    ``weight`` and ``bn.*``. The JAX package's ``train/torch_import`` has
    no mapping for them; ``weights.state_dict_from_jax`` carries them from
    the JAX package's variables.
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, relu=True,
                 use_bn=True):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.relu = k, relu
        self.conv_offset = nn.Conv2d(in_channels, 3 * k * k, k,
                                     padding=k // 2, bias=True)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))
        self.bn = nn.BatchNorm2d(out_channels) if use_bn else None

    def reset_parameters(self, generator=None):
        """The conv's weight with torch's default initialization, the
        offset conv at zero."""
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5),
                                 generator=generator)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x):
        kk = self.kernel_size ** 2
        offmod = self.conv_offset(x)
        y = deform_conv2d(x, offmod[:, :2 * kk],
                          torch.sigmoid(offmod[:, 2 * kk:].float()),
                          self.weight, kernel_size=self.kernel_size)
        if self.bn is not None:
            y = self.bn(y)
        return F.relu(y) if self.relu else y


class ConvexUpsampleHead(nn.Module):
    """Mask head for convex upsampling: conv3x3 -> ReLU -> conv1x1 giving
    9*(2^scale)^2 logits per pixel, both convs bias-free."""

    def __init__(self, feature_dim=32, scale=2):
        super().__init__()
        self.upsample_mask = nn.Sequential(
            nn.Conv2d(feature_dim, 64, 3, 1, 1, bias=False),
            nn.ReLU(inplace=True),
            nn.Conv2d(64, (2 ** scale) ** 2 * 9, 1, bias=False))

    def forward(self, feat):
        return self.upsample_mask(feat)
