"""The models of MOVEDepth in plain PyTorch, frozen for the benchmark.

A copy of the shipped pipeline's models (ResNet encoders, monodepth2's
depth decoder, the pose decoder, FPN4, Reg3D, the uncertainty head and the
convex-upsampling head) in the reference repository's module structure,
so that their ``state_dict`` keys are the program's and one set of
tensors loads into both. Only the shipped options are here: no deformable
FPN head, no Reg2D.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

NUM_CH_DEC = (16, 32, 64, 128, 256)
Conv2d, Conv3d, ConvTranspose3d = nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d


# ---------------------------------------------------------------- blocks

class Conv3x3(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.pad = nn.ReflectionPad2d(1)
        self.conv = Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(self.pad(x))


class ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv3x3(cin, cout)
        self.nonlin = nn.ELU()

    def forward(self, x):
        return self.nonlin(self.conv(x))


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvBnReLU3D(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv = Conv3d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn = nn.BatchNorm3d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


# ---------------------------------------------------------------- ResNet

BLOCKS = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
          50: ("bottleneck", (3, 4, 6, 3)),
          101: ("bottleneck", (3, 4, 23, 3)),
          152: ("bottleneck", (3, 8, 36, 3))}


def encoder_channels(arch):
    return (64, 64, 128, 256, 512) if arch <= 34 else (64, 256, 512, 1024,
                                                       2048)


def _down(cin, cout, stride):
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (_down(cin, planes, stride)
                           if stride != 1 or cin != planes else None)

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + idn)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (_down(cin, planes * 4, stride)
                           if stride != 1 or cin != planes * 4 else None)

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + idn)


class ResNetEncoder(nn.Module):
    """Features at strides 2-32 of torchvision's ResNet ``arch`` (``encoder.*``
    keys), input normalized as (x - 0.45) / 0.225."""

    def __init__(self, arch=18, num_input_images=1):
        super().__init__()
        kind, layers = BLOCKS[arch]
        block = BasicBlock if kind == "basic" else Bottleneck
        enc = nn.Module()
        enc.conv1 = Conv2d(3 * num_input_images, 64, 7, 2, 3, bias=False)
        enc.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for s, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for i in range(n):
                blocks.append(block(cin, planes, 2 if s > 0 and i == 0 else 1))
                cin = planes * block.expansion
            setattr(enc, f"layer{s + 1}", nn.Sequential(*blocks))
        self.encoder = enc

    def forward(self, x):
        enc = self.encoder
        x = F.relu(enc.bn1(enc.conv1((x - 0.45) / 0.225)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (enc.layer1, enc.layer2, enc.layer3, enc.layer4):
            x = layer(x)
            feats.append(x)
        return feats


# ---------------------------------------------------------------- decoders

class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc, scales=(0, 1, 2, 3)):
        super().__init__()
        self.scales = tuple(scales)
        mods = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            mods.append(ConvBlock(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            mods.append(ConvBlock(cin, NUM_CH_DEC[i]))
        mods += [Conv3x3(NUM_CH_DEC[s], 1) for s in self.scales]
        self.decoder = nn.ModuleList(mods)

    def forward(self, feats):
        out = {}
        x = feats[-1]
        for n, i in enumerate(range(4, -1, -1)):
            x = F.interpolate(self.decoder[2 * n](x), scale_factor=2,
                              mode="nearest")
            if i > 0:
                x = torch.cat([x, feats[i - 1]], dim=1)
            x = self.decoder[2 * n + 1](x)
            if i in self.scales:
                head = self.decoder[10 + self.scales.index(i)]
                out[("disp", i)] = torch.sigmoid(head(x))
        return out


class UncertNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(1, 8, 3, 1, 1, bias=False),
                                   nn.BatchNorm2d(8), nn.ReLU())
        self.conv2 = nn.Sequential(Conv2d(8, 8, 3, 1, 1, bias=False),
                                   nn.BatchNorm2d(8), nn.ReLU())
        self.head_convs = Conv2d(8, 1, 3, 1, 1, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.head_convs(self.conv2(self.conv1(x)) + x))


class PoseDecoder(nn.Module):
    def __init__(self, num_ch_enc, frames=2):
        super().__init__()
        self.frames = frames
        self.net = nn.ModuleList([Conv2d(num_ch_enc[-1], 256, 1),
                                  Conv2d(256, 256, 3, 1, 1),
                                  Conv2d(256, 256, 3, 1, 1),
                                  Conv2d(256, 6 * frames, 1)])

    def forward(self, feats):
        out = F.relu(self.net[0](feats[-1]))
        out = F.relu(self.net[1](out))
        out = F.relu(self.net[2](out))
        out = 0.01 * self.net[3](out).mean(3).mean(2).view(-1, self.frames,
                                                            1, 6)
        return out[..., :3], out[..., 3:]


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class FPN4(nn.Module):
    """(matching feature, context feature) at 1/2^scale resolution."""

    def __init__(self, base_channels=8, scale=2):
        super().__init__()
        bc = base_channels
        self.scale = scale
        self.conv0 = nn.Sequential(ConvBNReLU(3, bc), ConvBNReLU(bc, bc))

        def stage(cin, cout):
            return nn.Sequential(ConvBNReLU(cin, cout, 5, 2),
                                 ConvBNReLU(cout, cout),
                                 ConvBNReLU(cout, cout))

        self.conv1 = stage(bc, bc * 2)
        self.conv2 = stage(bc * 2, bc * 4)
        self.conv3 = stage(bc * 4, bc * 8)
        final = bc * 8
        if scale < 3:
            self.inner1 = Conv2d(bc * 4, final, 1, bias=True)
        if scale < 2:
            self.inner2 = Conv2d(bc * 2, final, 1, bias=True)
        if scale < 1:
            self.inner3 = Conv2d(bc, final, 1, bias=True)
        if scale == 3:
            self.out = Conv2d(final, bc * 8, 1, bias=False)
        else:
            self.out = Conv2d(final, {2: bc * 4, 1: bc * 2, 0: bc}[scale], 3,
                              padding=1, bias=False)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        intra = c3
        if self.scale < 3:
            intra = _up2(intra) + self.inner1(c2)
        if self.scale < 2:
            intra = _up2(intra) + self.inner2(c1)
        if self.scale < 1:
            intra = _up2(intra) + self.inner3(c0)
        return self.out(intra), {3: c3, 2: c2, 1: c1, 0: c0}[self.scale]


class Reg3D(nn.Module):
    """3-D U-Net over (B, G, D, H, W) -> (B, D, H, W) logits."""

    def __init__(self, c=16):
        super().__init__()
        self.conv0 = ConvBnReLU3D(c, c)
        self.conv1 = ConvBnReLU3D(c, c * 2, stride=2)
        self.conv2 = ConvBnReLU3D(c * 2, c * 2)
        self.conv3 = ConvBnReLU3D(c * 2, c * 4, stride=2)
        self.conv4 = ConvBnReLU3D(c * 4, c * 4)
        self.conv5 = ConvBnReLU3D(c * 4, c * 8, stride=2)
        self.conv6 = ConvBnReLU3D(c * 8, c * 8)

        def up(cin, cout):
            return nn.Sequential(
                ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                output_padding=1, bias=False),
                nn.BatchNorm3d(cout), nn.ReLU())

        self.conv7 = up(c * 8, c * 4)
        self.conv9 = up(c * 4, c * 2)
        self.conv11 = up(c * 2, c)
        self.prob = Conv3d(c, 1, 3, stride=1, padding=1, bias=False)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        x = self.conv6(self.conv5(c4))
        x = c4 + self.conv7(x)
        x = c2 + self.conv9(x)
        x = c0 + self.conv11(x)
        return self.prob(x)[:, 0]


class ConvexUpsampleHead(nn.Module):
    def __init__(self, feature_dim=32, scale=2):
        super().__init__()
        self.upsample_mask = nn.Sequential(
            Conv2d(feature_dim, 64, 3, 1, 1, bias=False), nn.ReLU(),
            Conv2d(64, (2 ** scale) ** 2 * 9, 1, bias=False))

    def forward(self, feat):
        return self.upsample_mask(feat)


def build(cfg, device):
    """The shipped pipeline's models on ``device``, uninitialized (the
    caller loads a state dict), in eval mode."""
    if cfg.dcn or cfg.num_depth_bins < 8 or cfg.load_pose or not cfg.convex_up:
        raise ValueError("the reference holds the shipped model only: no "
                         "dcn, Reg3D (>= 8 bins), PoseNet, convex upsampling")
    ch = encoder_channels(cfg.res_arch)
    with torch.device("meta"):
        models = {
            "mono_encoder": ResNetEncoder(cfg.res_arch),
            "mono_depth": DepthDecoder(ch, cfg.scales),
            "mask_cnn": UncertNet(),
            "mvs_encoder": FPN4(8, cfg.prior_scale),
            "reg3d": Reg3D(cfg.reg3d_c),
            "pose_encoder": ResNetEncoder(cfg.res_arch, num_input_images=2),
            "pose": PoseDecoder(ch, 2),
            "up": ConvexUpsampleHead(8 * 2 ** cfg.prior_scale,
                                     cfg.prior_scale),
        }
    return {k: m.to_empty(device=device).eval() for k, m in models.items()}
