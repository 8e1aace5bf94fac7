"""Resizing (port of ``resize_bilinear`` and ``upsample_nearest_2x`` in
movedepth_tpu/ops/sampling.py) with torch's coordinate conventions."""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(img, out_hw, align_corners=False):
    """``F.interpolate(mode='bilinear')`` of (B, C, H, W) or (B, H, W)
    tensors, for both align_corners conventions (edges clamp)."""
    if tuple(img.shape[-2:]) == tuple(out_hw):
        return img
    if img.dim() == 3:
        return resize_bilinear(img[:, None], out_hw, align_corners)[:, 0]
    return F.interpolate(img, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def upsample_nearest_2x(img):
    """``F.interpolate(scale_factor=2, mode='nearest')`` of (B, C, H, W)
    tensors: every pixel repeated over a 2x2 block."""
    return F.interpolate(img, scale_factor=2, mode="nearest")
