"""Losses and volume statistics (port of movedepth_tpu/ops/losses.py; the
inference slice needs only ``entropy``)."""

from __future__ import annotations

import torch


def entropy(volume, dim, keepdim=False):
    """Shannon entropy of a probability volume along ``dim``."""
    clamped = torch.clamp(volume, 1e-9, 1.0)
    return torch.sum(-volume * torch.log(clamped), dim=dim, keepdim=keepdim)
