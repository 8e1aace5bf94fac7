"""ResNet pyramid encoder (port of movedepth_tpu/models/resnet.py).

Written out by hand in torchvision's structure (no torchvision here), so
the ``encoder.*`` state_dict keys are those of the reference's
ResnetEncoder. Inputs are NCHW images in [0, 1]; ``num_input_images=2``
stacks two frames on the channels for the pose encoder.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from movedepth_tpu_torch.models.layers import max_pool_3x3_s2

# arch -> (block, blocks per stage), torchvision's tables
RESNET_BLOCKS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def encoder_channels(arch):
    """Per-level feature channels of the 5-level pyramid: the bottleneck
    encoders (arch > 34) widen levels 1-4 four times."""
    return (64, 64, 128, 256, 512) if arch <= 34 else (64, 256, 512, 1024,
                                                       2048)


def _downsample(cin, cout, stride):
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (_downsample(cin, planes, stride)
                           if stride != 1 or cin != planes else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)), inplace=True)
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity, inplace=True)


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: the stride sits on the 3x3 conv."""

    expansion = 4

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        cout = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = (_downsample(cin, cout, stride)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)), inplace=True)
        out = F.relu(self.bn2(self.conv2(out)), inplace=True)
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity, inplace=True)


def _stem_and_stages(arch, num_input_images, stages):
    """torchvision's ``conv1``, ``bn1`` and the first ``stages`` stages
    (``layer1``...) of ResNet ``arch``, as attributes of one module."""
    if arch not in RESNET_BLOCKS:
        raise ValueError(f"ResNet{arch}: res_arch must be one of "
                         f"{sorted(RESNET_BLOCKS)}")
    kind, layers = RESNET_BLOCKS[arch]
    block = BasicBlock if kind == "basic" else Bottleneck
    enc = nn.Module()
    enc.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, 2, 3, bias=False)
    enc.bn1 = nn.BatchNorm2d(64)
    cin = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                            layers[:stages])):
        blocks = []
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            blocks.append(block(cin, planes, stride))
            cin = planes * block.expansion
        setattr(enc, f"layer{stage + 1}", nn.Sequential(*blocks))
    return enc


class ResNetEncoder(nn.Module):
    """5-level feature pyramid: features at strides 2, 4, 8, 16, 32 with
    ``encoder_channels(arch)`` channels. Normalizes (x - 0.45) / 0.225."""

    def __init__(self, arch=18, num_input_images=1):
        super().__init__()
        self.encoder = _stem_and_stages(arch, num_input_images, 4)

    def forward(self, x):
        enc = self.encoder
        x = F.relu(enc.bn1(enc.conv1((x - 0.45) / 0.225)), inplace=True)
        feats = [x]
        x = max_pool_3x3_s2(x)
        for layer in (enc.layer1, enc.layer2, enc.layer3, enc.layer4):
            x = layer(x)
            feats.append(x)
        return feats


class ContextEncoder(nn.Module):
    """The stem and the first stage of ResNet ``arch`` -> one stride-4
    feature (64 channels; 256 for the bottleneck encoders), with the
    encoder's ``encoder.*`` state_dict keys and input normalization."""

    def __init__(self, arch=18, num_input_images=1):
        super().__init__()
        self.encoder = _stem_and_stages(arch, num_input_images, 1)

    def forward(self, x):
        enc = self.encoder
        x = F.relu(enc.bn1(enc.conv1((x - 0.45) / 0.225)), inplace=True)
        return enc.layer1(max_pool_3x3_s2(x))
