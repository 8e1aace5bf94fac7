"""RAFT-style learned convex upsampling (port of
movedepth_tpu/ops/upsample.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(depth, mask, scale=2):
    """Upsample depth (B, H, W) by s = 2**scale with learned 9-tap convex
    weights. ``mask``: (B, 9*s*s, H, W) logits from the mask head, channels
    laid out as (9, s, s). Returns (B, H*s, W*s)."""
    s = 2 ** scale
    b, h, w = depth.shape
    weights = torch.softmax(mask.view(b, 9, s, s, h, w), dim=1)
    taps = F.unfold(depth[:, None], kernel_size=3, padding=1)  # (B, 9, H*W)
    up = torch.sum(weights * taps.view(b, 9, 1, 1, h, w), dim=1)  # (B,s,s,H,W)
    return up.permute(0, 3, 1, 4, 2).reshape(b, h * s, w * s)
