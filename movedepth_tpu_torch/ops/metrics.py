"""Depth error metrics in torch, on any device (port of
movedepth_tpu/ops/metrics.py; reference: movedepth/layers.py:718-736 and
movedepth/evaluate_depth.py:22-64)."""

from __future__ import annotations

import torch

METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def compute_depth_errors(gt, pred, mask=None):
    """The 7 standard KITTI depth metrics.

    gt / pred: same-shape tensors of positive depths. ``mask`` (optional,
    same shape, float or bool) restricts the statistics to valid pixels
    with weights instead of boolean indexing: masked-out pixels are set to
    1 before the ratios and every mean is sum(x * w) / (sum(w) + 1e-12).
    Computes in float64 when either input is float64, else in float32.
    Returns a dict of 0-d tensors of that type keyed by METRIC_NAMES.
    """
    dtype = torch.promote_types(gt.dtype, pred.dtype)
    if dtype != torch.float64:
        dtype = torch.float32
    gt = gt.to(dtype)
    pred = pred.to(dtype)
    if mask is None:
        w = torch.ones_like(gt)
    else:
        w = mask.to(dtype)
        # keep ratios finite on masked-out pixels
        one = torch.ones_like(gt)
        gt = torch.where(w > 0, gt, one)
        pred = torch.where(w > 0, pred, one)
    n = w.sum() + 1e-12

    def wmean(x):
        return (x * w).sum() / n

    thresh = torch.maximum(gt / pred, pred / gt)
    a1 = wmean((thresh < 1.25).to(dtype))
    a2 = wmean((thresh < 1.25 ** 2).to(dtype))
    a3 = wmean((thresh < 1.25 ** 3).to(dtype))

    rmse = torch.sqrt(wmean((gt - pred) ** 2))
    rmse_log = torch.sqrt(wmean((torch.log(gt) - torch.log(pred)) ** 2))
    abs_rel = wmean(torch.abs(gt - pred) / gt)
    sq_rel = wmean((gt - pred) ** 2 / gt)

    return dict(
        abs_rel=abs_rel, sq_rel=sq_rel, rmse=rmse, rmse_log=rmse_log,
        a1=a1, a2=a2, a3=a3,
    )


def oracle_fuse_errors(gt, pred_mono, pred_mvs):
    """Oracle per-pixel best-of-two "upbound" metric
    (reference: movedepth/evaluate_depth.py:42-64)."""
    use_mono = torch.abs(gt - pred_mono) < torch.abs(pred_mvs - gt)
    pred = torch.where(use_mono, pred_mono, pred_mvs)
    return compute_depth_errors(gt, pred)
