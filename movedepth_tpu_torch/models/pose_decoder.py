"""Pose regression heads (port of movedepth_tpu/models/pose_decoder.py).

PoseDecoder: ``net.0`` squeeze 1x1, ``net.1``/``net.2`` 3x3, ``net.3``
6-DoF 1x1. PoseCNN, monodepth2's alternate pose network over stacked
frames: seven strided convs ``net.0``-``net.6`` and ``pose_conv``, the
state_dict names of monodepth2's ``pose_cnn.py``."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class PoseDecoder(nn.Module):
    """Encoder pyramids -> (axisangle, translation), each (B, F, 1, 3):
    squeeze -> 3 convs -> global mean -> 0.01 * 6-DoF per frame. One input
    pyramid (the pose encoder sees both frames stacked)."""

    def __init__(self, num_ch_enc, num_frames_to_predict_for=2):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1),
            nn.Conv2d(256, 256, 3, 1, 1),
            nn.Conv2d(256, 256, 3, 1, 1),
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1),
        ])

    def forward(self, input_features):
        (feats,) = input_features
        out = F.relu(self.net[0](feats[-1]))
        out = F.relu(self.net[1](out), inplace=True)
        out = F.relu(self.net[2](out), inplace=True)
        out = self.net[3](out).mean(3).mean(2)
        out = 0.01 * out.view(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]


class PoseCNN(nn.Module):
    """``num_input_frames`` frames stacked on the channels (B, 3N, H, W)
    -> (axisangle, translation), each (B, N-1, 1, 3): seven stride-2 convs
    with ReLU, a 1x1 6-DoF conv, the global mean, times 0.01."""

    def __init__(self, num_input_frames):
        super().__init__()
        self.num_input_frames = num_input_frames
        chans = (3 * num_input_frames, 16, 32, 64, 128, 256, 256, 256)
        kernels = (7, 5, 3, 3, 3, 3, 3)
        self.net = nn.ModuleList([
            nn.Conv2d(cin, cout, k, 2, (k - 1) // 2)
            for cin, cout, k in zip(chans[:-1], chans[1:], kernels)])
        self.pose_conv = nn.Conv2d(256, 6 * (num_input_frames - 1), 1)

    def forward(self, x):
        for conv in self.net:
            x = F.relu(conv(x), inplace=True)
        out = self.pose_conv(x).mean(3).mean(2)
        out = 0.01 * out.view(-1, self.num_input_frames - 1, 1, 6)
        return out[..., :3], out[..., 3:]
