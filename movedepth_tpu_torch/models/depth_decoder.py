"""monodepth2-style depth decoder and uncertainty head (port of
movedepth_tpu/models/depth_decoder.py) in the reference's structure:
``decoder.N`` holds upconv (4..0, 0/1) at N = 0..9, then one dispconv per
scale, so the state_dict keys are the reference's."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from movedepth_tpu_torch.models.layers import Conv3x3, ConvBlock

NUM_CH_DEC = (16, 32, 64, 128, 256)


class DepthDecoder(nn.Module):
    """U-Net decoder over the 5-level encoder pyramid -> {("disp", s):
    (B, 1, H/2^s, W/2^s) sigmoid disparity} for s in ``scales``."""

    def __init__(self, num_ch_enc, scales=(0, 1, 2, 3)):
        super().__init__()
        self.scales = tuple(scales)
        mods = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            mods.append(ConvBlock(cin, NUM_CH_DEC[i]))  # upconv_i_0
            cin = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            mods.append(ConvBlock(cin, NUM_CH_DEC[i]))  # upconv_i_1
        mods += [Conv3x3(NUM_CH_DEC[s], 1) for s in self.scales]  # dispconv_s
        self.decoder = nn.ModuleList(mods)

    def forward(self, input_features):
        outputs = {}
        x = input_features[-1]
        for n, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * n](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, input_features[i - 1]], dim=1)
            x = self.decoder[2 * n + 1](x)
            if i in self.scales:
                head = self.decoder[10 + self.scales.index(i)]
                outputs[("disp", i)] = torch.sigmoid(head(x))
        return outputs


class UncertNet(nn.Module):
    """Cost-volume entropy (B, 1, H, W) -> "trust mono" weight in (0, 1).
    The residual adds the 1-channel input to all 8 hidden channels."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(1, 8, 3, 1, 1, bias=False),
                                   nn.BatchNorm2d(8), nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(nn.Conv2d(8, 8, 3, 1, 1, bias=False),
                                   nn.BatchNorm2d(8), nn.ReLU(inplace=True))
        self.head_convs = nn.Conv2d(8, 1, 3, 1, 1, bias=False)

    def forward(self, x):
        out = self.conv2(self.conv1(x)) + x
        return torch.sigmoid(self.head_convs(out))
