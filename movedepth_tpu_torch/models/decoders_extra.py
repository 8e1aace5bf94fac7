"""Experimental decoder variants (port of
movedepth_tpu/models/decoders_extra.py): the reference's decoders and
depth refiner that no shipped configuration uses, NCHW.

The reference's positional ``decoder.N`` order of these variants' extra
heads is not recorded in this repository, so their state_dict names are
the JAX package's flax module paths, dotted as ``weights._attr`` dots
them: ``upconv_4_0`` is ``upconv.4.0`` (``upconv[i][j]``), ``dispconv_2``
is ``dispconv.2`` (a ModuleDict keyed by scale), ``depth_3dcnn_2_a`` is
``depth_3dcnn.2.a``, ``block_0`` is ``block.0``; ``reduce_conv``,
``in_conv`` and ``out_conv`` keep their names.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from movedepth_tpu_torch.models.depth_decoder import NUM_CH_DEC
from movedepth_tpu_torch.models.layers import Conv3x3, ConvBlock
from movedepth_tpu_torch.ops.sampling import upsample_nearest_2x


def depth_grid(discret, bins, min_d=0.001, max_d=1.0, dtype=torch.float32,
               device=None):
    """SID (log-spaced) or UD (uniform) depth discretization, (1, D, 1, 1)
    to broadcast over NCHW maps."""
    if discret == "SID":
        k = torch.arange(bins, dtype=dtype, device=device)
        t = torch.exp(torch.log(torch.tensor(min_d, dtype=dtype))
                      + torch.log(torch.tensor(max_d / min_d, dtype=dtype))
                      * k / bins)
    elif discret == "UD":
        t = torch.linspace(min_d, max_d, bins, dtype=dtype, device=device)
    else:
        raise ValueError(discret)
    return t.reshape(1, bins, 1, 1)


def _upconvs(num_ch_enc, use_skips=True):
    """``upconv[i][0]`` and ``upconv[i][1]`` for the levels i = 0..4 of a
    monodepth2 decoder over the encoder pyramid ``num_ch_enc``."""
    levels = []
    for i in range(5):
        cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
        skip = num_ch_enc[i - 1] if use_skips and i > 0 else 0
        levels.append(nn.ModuleList([
            ConvBlock(cin, NUM_CH_DEC[i]),
            ConvBlock(NUM_CH_DEC[i] + skip, NUM_CH_DEC[i])]))
    return nn.ModuleList(levels)


def _heads(scales, make):
    return nn.ModuleDict({str(s): make(s) for s in scales})


class _Decoder(nn.Module):
    """The U-Net walk the variants share: for i = 4..0, upconv[i][0],
    nearest 2x, ``inject(i, x)``, the skip, upconv[i][1], then the
    variant's ``_head(i, x, outputs)``."""

    def __init__(self, num_ch_enc, use_skips=True):
        super().__init__()
        self.use_skips = use_skips
        self.upconv = _upconvs(num_ch_enc, use_skips)

    def _walk(self, feats, inject=None):
        outputs = {}
        x = feats[-1]
        for i in range(4, -1, -1):
            x = upsample_nearest_2x(self.upconv[i][0](x))
            if inject is not None:
                x = inject(i, x)
            if self.use_skips and i > 0:
                x = torch.cat([x, feats[i - 1]], dim=1)
            x = self.upconv[i][1](x)
            self._head(i, x, outputs)
        return outputs


class MPMDecoder(_Decoder):
    """A decoder that injects the cost volume (B, num_bins, H/4, W/4) at
    1/4 scale through ``reduce_conv`` -> {("mpm_disp", s): (B, 1, H/2^s,
    W/2^s)} for s in 2, 1, 0."""

    def __init__(self, num_ch_enc, num_bins=8, use_skips=True):
        super().__init__(num_ch_enc, use_skips)
        self.reduce_conv = nn.Conv2d(NUM_CH_DEC[2] + num_bins, NUM_CH_DEC[2],
                                     1)
        self.dispconv = _heads((2, 1, 0), lambda s: Conv3x3(NUM_CH_DEC[s],
                                                            1))

    def forward(self, costvol, mono_feats):
        def inject(i, x):
            if i != 2:
                return x
            return self.reduce_conv(torch.cat([x, costvol], dim=1))

        return self._walk(mono_feats, inject)

    def _head(self, i, x, outputs):
        if i in (2, 1, 0):
            outputs[("mpm_disp", i)] = torch.sigmoid(
                self.dispconv[str(i)](x))


class DepthDecoder3D(_Decoder):
    """Per-scale depth classification: a ConvBlock expands the decoder
    feature to ``reg_c`` x ``mono_bins`` channels, read as a (B, reg_c,
    mono_bins, H, W) volume; two 3x3x3 Conv3d (ELU between), a softmax
    over the bins and the expectation over ``depth_grid`` -> {("mono_depth",
    s): (B, 1, H/2^s, W/2^s)} for s in ``scales``."""

    def __init__(self, num_ch_enc, scales=(0, 1, 2, 3), discret="UD",
                 mono_bins=96, min_d=0.1, max_d=10.0, reg_c=4):
        super().__init__(num_ch_enc, use_skips=True)
        self.scales = tuple(scales)
        self.discret, self.min_d, self.max_d = discret, min_d, max_d
        self.mono_bins, self.reg_c = mono_bins, reg_c
        self.depth_expand = _heads(
            self.scales, lambda s: ConvBlock(NUM_CH_DEC[s], mono_bins * reg_c))
        self.depth_3dcnn = _heads(self.scales, lambda s: nn.ModuleDict({
            "a": nn.Conv3d(reg_c, reg_c, 3, padding=1, bias=False),
            "b": nn.Conv3d(reg_c, 1, 3, padding=1, bias=False)}))

    def forward(self, input_features):
        return self._walk(input_features)

    def _head(self, i, x, outputs):
        if i not in self.scales:
            return
        feat = self.depth_expand[str(i)](x)
        b, _, h, w = feat.shape
        vol = feat.view(b, self.reg_c, self.mono_bins, h, w)
        cnn = self.depth_3dcnn[str(i)]
        vol = cnn["b"](F.elu(cnn["a"](vol)))
        prob = torch.softmax(vol[:, 0], dim=1)  # (B, D, H, W)
        grid = depth_grid(self.discret, self.mono_bins, self.min_d,
                          self.max_d, prob.dtype, prob.device)
        outputs[("mono_depth", i)] = torch.sum(prob * grid, dim=1,
                                               keepdim=True)


class DepthDecoderBin(_Decoder):
    """The disparity head beside a bin-softmax head -> {("disp", s): (B, 1,
    H/2^s, W/2^s), ("bin", s): (B, mono_bins, H/2^s, W/2^s)}."""

    def __init__(self, num_ch_enc, scales=(0, 1, 2, 3), use_skips=True,
                 mono_bins=96):
        super().__init__(num_ch_enc, use_skips)
        self.scales = tuple(scales)
        self.dispconv = _heads(self.scales,
                               lambda s: Conv3x3(NUM_CH_DEC[s], 1))
        self.binconv = _heads(self.scales,
                              lambda s: Conv3x3(NUM_CH_DEC[s], mono_bins))

    def forward(self, input_features):
        return self._walk(input_features)

    def _head(self, i, x, outputs):
        if i in self.scales:
            outputs[("disp", i)] = torch.sigmoid(self.dispconv[str(i)](x))
            outputs[("bin", i)] = torch.softmax(self.binconv[str(i)](x),
                                                dim=1)


class DepthDecoder3Head(_Decoder):
    """Four sigmoid disparity heads from one 4-channel conv ->
    ("disp_rough", s), ("disp_1", s), ("disp_2", s), ("disp_3", s)."""

    def __init__(self, num_ch_enc, scales=(0, 1, 2, 3), use_skips=True):
        super().__init__(num_ch_enc, use_skips)
        self.scales = tuple(scales)
        self.dispconv = _heads(self.scales,
                               lambda s: Conv3x3(NUM_CH_DEC[s], 4))

    def forward(self, input_features):
        return self._walk(input_features)

    def _head(self, i, x, outputs):
        if i in self.scales:
            disp = torch.sigmoid(self.dispconv[str(i)](x))
            for c, key in enumerate(("disp_rough", "disp_1", "disp_2",
                                     "disp_3")):
                outputs[(key, i)] = disp[:, c:c + 1]


class ResBlockWDSR(nn.Module):
    """WDSR-style residual block with the disparity (B, 1, H, W)
    concatenated in front of the features (B, n_feats, H, W)."""

    def __init__(self, n_feats, expansion=3, res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv0 = nn.Conv2d(n_feats + 1, n_feats * expansion, 3,
                               padding=1)
        self.conv1 = nn.Conv2d(n_feats * expansion, n_feats, 3, padding=1)

    def forward(self, x, disp):
        h = F.relu(self.conv0(torch.cat([disp, x], dim=1)), inplace=True)
        return x + self.conv1(h) * self.res_scale


class ContextAdjustmentLayer(nn.Module):
    """Image-guided depth refinement: the depth (B, 1, H, W), normalized by
    its mean and standard deviation over the whole batch, with the image
    (B, 3, H, W) through ``num_blocks`` :class:`ResBlockWDSR`; the residual
    is added and the normalization undone."""

    def __init__(self, num_blocks=8, feature_dim=16, expansion=3):
        super().__init__()
        self.in_conv = nn.Conv2d(4, feature_dim, 3, padding=1)
        self.block = nn.ModuleList([ResBlockWDSR(feature_dim, expansion)
                                    for _ in range(num_blocks)])
        self.out_conv = nn.Conv2d(feature_dim, 1, 3, padding=1)

    def forward(self, fused_depth, img):
        mean = torch.mean(fused_depth)
        std = torch.std(fused_depth, correction=0) + 1e-6
        norm = (fused_depth - mean) / std
        feat = self.in_conv(torch.cat([norm, img], dim=1))
        for block in self.block:
            feat = block(feat, norm)
        return (norm + self.out_conv(feat)) * std + mean
