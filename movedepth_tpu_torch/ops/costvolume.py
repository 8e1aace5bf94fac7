"""Velocity-guided plane-sweep cost volume (port of
movedepth_tpu/ops/costvolume.py, inference half).

Layouts as in the JAX package: features NHWC (B, H, W, C); depth bins
(B, D, H, W); cost volumes (B, D, H, W, G).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from movedepth_tpu_torch.ops.geometry import pixel_grid


def _bin_positions(ndepth, schedule_type, dtype=torch.float32, device=None):
    """Interpolation positions in [0, 1] for D bins (1-D tensor)."""
    k = torch.arange(ndepth, dtype=dtype, device=device)
    if schedule_type in ("inverse", "linear"):
        return k / (ndepth - 1)
    if schedule_type == "log":  # geometric 0.1 -> 1.0
        return torch.exp(torch.log(torch.tensor(0.1, dtype=dtype))
                         + torch.log(torch.tensor(10.0, dtype=dtype))
                         * k / (ndepth - 1))
    raise ValueError(f"unknown schedule_type {schedule_type!r}")


def _spread_bins(lo, hi, ndepth, schedule_type):
    """Per-pixel [lo, hi] (B, H, W) -> D hypotheses (B, D, H, W). 'inverse'
    is uniform in inverse depth from hi down to lo (bin 0 is the farthest);
    'linear' and 'log' interpolate in depth from lo to hi."""
    itv = _bin_positions(ndepth, schedule_type, lo.dtype,
                         lo.device)[None, :, None, None]
    lo = lo[:, None]
    hi = hi[:, None]
    if schedule_type == "inverse":
        return 1.0 / (1.0 / hi + (1.0 / lo - 1.0 / hi) * itv)
    return lo + (hi - lo) * itv


def schedule_depth_bins_v1(disp, ndepth, scale_fac, min_depth, max_depth,
                           schedule_type="inverse", is_depth=False,
                           geo_mask=None, damper=1.0, z_trans=None):
    """The v1 range scheduler (disparity or depth (B, H, W) -> (B, D, H,
    W)), kept beside the functions below that superseded it.

    A band of half-width ``itv * fac * D / 2`` around the depth from
    ``disp`` (``is_depth``: ``disp`` is that depth), with itv = (the
    image's max - min) / 96, clamped into the image's [min, max]. Where
    ``geo_mask`` holds, fac is ``scale_fac / damper``; ``z_trans`` (B,)
    scales the band per image. No gradient flows to ``disp``.
    """
    disp = disp.detach()
    if is_depth:
        center = disp
    else:
        center = 1.0 / (1.0 / max_depth
                        + disp * (1.0 / min_depth - 1.0 / max_depth))
    flat = center.reshape(center.shape[0], -1)
    dmax = flat.max(dim=1).values[:, None, None]
    dmin = flat.min(dim=1).values[:, None, None]
    itv = (dmax - dmin) / 96.0  # the reference's constant
    fac = torch.full_like(center, scale_fac)
    if geo_mask is not None:
        fac = torch.where(geo_mask, fac / damper, fac)
    half = itv * fac * ndepth / 2.0
    if z_trans is not None:
        half = half * z_trans.detach()[:, None, None]
    lo = torch.maximum(center - half, dmin)
    hi = torch.minimum(center + half, dmax)
    return _spread_bins(lo, hi, ndepth, schedule_type)


def schedule_depth_bins(prior_depth, ndepth, scale_fac,
                        schedule_type="inverse"):
    """Candidates in [prior/(1+fac), prior*(1+fac)]: (B,H,W) -> (B,D,H,W)."""
    prior_depth = prior_depth.detach()
    return _spread_bins(prior_depth / (1.0 + scale_fac),
                        prior_depth * (1.0 + scale_fac), ndepth,
                        schedule_type)


def schedule_depth_bins_z(prior_depth, ndepth, scale_fac, z_trans,
                          schedule_type="inverse"):
    """Velocity-guided candidates: the band scales with ``z_trans``, the
    pre-scaled camera z-translation broadcastable to (B, H, W)."""
    prior_depth = prior_depth.detach()
    z_trans = torch.broadcast_to(z_trans, prior_depth.shape).detach()
    return _spread_bins(prior_depth / (1.0 + scale_fac * z_trans),
                        prior_depth * (1.0 + scale_fac * z_trans), ndepth,
                        schedule_type)


def sweep_grid(depth_bins, K, inv_K, T, eps=1e-7):
    """Normalized sampling grid (B, D, H, W, 2) in [-1, 1] for all depth
    hypotheses. depth_bins: (B, D, H, W); K, inv_K, T: (B, 4, 4)."""
    b, d, h, w = depth_bins.shape
    pix = pixel_grid(h, w, depth_bins.dtype, depth_bins.device)
    rays = inv_K[:, :3, :3] @ pix  # (B, 3, HW)
    pts = depth_bins.reshape(b, d, 1, h * w) * rays[:, None]
    P = (K @ T)[:, :3, :]
    cam = (torch.einsum("bij,bdjp->bdip", P[:, :, :3], pts)
           + P[:, :, 3:4][:, None])
    xy = cam[:, :, :2, :] / (cam[:, :, 2:3, :] + eps)
    gx = (xy[:, :, 0, :] / (w - 1) - 0.5) * 2.0
    gy = (xy[:, :, 1, :] / (h - 1) - 0.5) * 2.0
    return torch.stack([gx, gy], dim=-1).reshape(b, d, h, w, 2).detach()


def plane_sweep_warp(src_feat, K, inv_K, depth_bins, T):
    """Zeros-padded bilinear warps of src (B, H, W, C) over all D depth
    hypotheses -> (B, D, H, W, C)."""
    b, d, h, w = depth_bins.shape
    c = src_feat.shape[-1]
    grid = sweep_grid(depth_bins, K, inv_K, T).reshape(b, d * h, w, 2)
    warped = F.grid_sample(src_feat.permute(0, 3, 1, 2), grid,
                           mode="bilinear", padding_mode="zeros",
                           align_corners=True)  # (B, C, D*H, W)
    return warped.view(b, c, d, h, w).permute(0, 2, 3, 4, 1)


def plane_sweep_costvol(ref_feat, src_feat, K, inv_K, depth_bins, T):
    """Warped src times ref: (B, D, H, W, C)."""
    return plane_sweep_warp(src_feat, K, inv_K, depth_bins, T) \
        * ref_feat[:, None]


def reduce_cost_groups(cost, num_groups):
    """Channel-group mean (B, D, H, W, C) -> (B, D, H, W, G): group g is
    the mean of channels k*G+g."""
    b, d, h, w, c = cost.shape
    return cost.reshape(b, d, h, w, c // num_groups, num_groups).mean(-2)


def fuse_frames(cost_list, weight_axis="group"):
    """Confidence-weighted fusion of per-source-frame volumes (B,D,H,W,G).

    Each frame's weight is the max of a softmax over the mean cost:
    over G for 'group' (training), over D after a group mean for 'depth'
    (eval). The accumulator starts at 1e-8 as in the reference. A single
    bf16 frame is returned as it is: its weight factor w/(1e-8+w) with
    w >= 1/D differs from 1 far below bf16 resolution.
    """
    if len(cost_list) == 1 and cost_list[0].dtype == torch.bfloat16:
        return cost_list[0]
    wsum = 1e-8
    acc = 0.0
    for cost in cost_list:
        if weight_axis == "group":
            w = torch.softmax(cost.mean(dim=1), dim=-1).amax(dim=-1)
        elif weight_axis == "depth":
            w = torch.softmax(cost.mean(dim=-1), dim=1).amax(dim=1)
        else:
            raise ValueError(weight_axis)
        wsum = wsum + w
        acc = acc + w[:, None, :, :, None] * cost
    return acc / wsum[:, None, :, :, None]


def localmax(cost_prob, radius, ndepth, inv_depth_min, inv_depth_max):
    """Windowed soft-argmax over depth bins -> depth map (B, H, W).

    The probabilities in +-radius bins around the argmax regress a
    normalized index, decoded as
    ``1 / (inv_depth_min + norm * (inv_depth_max - inv_depth_min))``.
    Callers pass inv_depth_min = 1/bins[:, -1] (the nearest hypothesis) and
    inv_depth_max = 1/bins[:, 0] (the farthest), so the decode is flipped
    against the bin order exactly as in the reference, which the
    regularizer is trained against. Window slots clipped onto an edge bin
    count that bin once per slot.
    """
    idx0 = torch.argmax(cost_prob, dim=1, keepdim=True)  # (B, 1, H, W)
    d_iota = torch.arange(ndepth, device=cost_prob.device)[None, :, None,
                                                           None]
    cnt = 0
    for o in range(-radius, radius + 1):
        cnt = cnt + (d_iota == torch.clamp(idx0 + o, 0, ndepth - 1))
    wprob = cost_prob * cnt.to(cost_prob.dtype)
    num = torch.sum(d_iota.to(cost_prob.dtype) * wprob, dim=1)
    den = 1e-6 + torch.sum(wprob, dim=1)
    norm = (num / den) / (ndepth - 1)
    return 1.0 / (inv_depth_min + norm * (inv_depth_max - inv_depth_min))
