"""Inference pipeline of the port (port of the inference half of
movedepth_tpu/pipeline.py).

Batches and outputs keep the JAX package's layouts and keys: ``color`` is
(B, F, H, W, 3) with frames in ``matching_ids`` order, ``K``/``inv_K`` are
(B, 4, 4), the optional ``relative_pose`` is (B, F-1, 4, 4); depth and
disparity maps come back as (B, H, W). Inside, models run in NCHW.

Models run under ``torch.autocast("cuda", torch.bfloat16)`` when
``cfg.compute_dtype`` is "bfloat16" and the batch is on a CUDA device, and
in float32 otherwise. Geometry, depth bins, the softmax and the decode
always run in float32, outside autocast.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from movedepth_tpu.config import Config
from movedepth_tpu.data.synthetic import make_batch
from movedepth_tpu_torch.ops.costvolume import (
    fuse_frames,
    localmax,
    schedule_depth_bins_z,
    sweep_grid,
)
from movedepth_tpu_torch.ops.geometry import (
    disp_to_depth,
    transformation_from_parameters,
)
from movedepth_tpu_torch.ops.losses import entropy
from movedepth_tpu_torch.ops.sampling import resize_bilinear
from movedepth_tpu_torch.ops.sweep_warp import grid_to_pixel, sweep_warp_corr
from movedepth_tpu_torch.ops.upsample import convex_upsample


def as_batch(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                         torch.Tensor]:
    """A numpy batch (e.g. from ``make_batch``) as tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in batch.items()}


def synthetic_batch(cfg: Config, batch_size: int, seed: int = 0,
                    device="cpu", with_pose: bool = False):
    """The JAX package's synthetic batch (smooth random frames, KITTI
    intrinsics) as tensors on ``device``."""
    return as_batch(make_batch(cfg, batch_size, seed, with_pose), device)


def _models_ctx(cfg: Config, device: torch.device):
    if cfg.compute_dtype == "bfloat16" and device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def scale_intrinsics(K, scale: int):
    """K at pyramid level ``scale``: focal/principal rows divided by 2^s."""
    if scale == 0:
        return K
    K = K.clone()
    K[..., 0:2, :] *= 1.0 / (2 ** scale)
    return K


def predict_poses(models, color, cfg: Config):
    """PoseNet on (frame, reference) pairs of ``color`` (B, F, H, W, 3),
    frames in ``cfg.frame_ids`` order -> relative poses (B, M, 4, 4) of
    ``matching_ids[1:]``, each the (inverted for a past frame)
    transform from the 6-DoF prediction."""
    fid_to_idx = {f: i for i, f in enumerate(cfg.frame_ids)}
    rel = []
    for f in cfg.matching_ids[1:]:
        pair = (color[:, fid_to_idx[f]], color[:, 0])
        if f > 0:
            pair = pair[::-1]
        with _models_ctx(cfg, color.device):
            feats = models["pose_encoder"](_nchw(torch.cat(pair, dim=-1)))
            aa, tr = models["pose"]([feats])
        rel.append(transformation_from_parameters(
            aa[:, 0, 0].float(), tr[:, 0, 0].float(), invert=f < 0))
    return torch.stack(rel, dim=1)


def poses_from_batch(batch, cfg: Config):
    """load_pose mode: the relative poses (B, M, 4, 4) of
    ``matching_ids[1:]`` come from the batch (``frame_ids[1:]`` order),
    not from PoseNet."""
    midx = [cfg.frame_ids[1:].index(f) for f in cfg.matching_ids[1:]]
    return batch["relative_pose"][:, midx]


def mvs_depth_from_features(models, ref_match, src_matches, depth_bins, K_p,
                            invK_p, rel, cfg: Config):
    """Cost volume -> Reg3D -> softmax -> localmax depth (inference; the
    frames fuse over the depth axis, as the reference's eval does).

    ref_match and each of src_matches: (B, C, h, w) FPN matching features.
    Returns (depth_mvs (B, h, w), cost_prob (B, D, h, w)).
    """
    h, w = depth_bins.shape[-2:]
    ref = ref_match.permute(0, 2, 3, 1).contiguous()  # NHWC for the kernel
    costs = []
    for f_idx, src in enumerate(src_matches):
        grid = sweep_grid(depth_bins, K_p, invK_p, rel[:, f_idx])
        sx, sy = grid_to_pixel(grid, h, w)
        costs.append(sweep_warp_corr(
            src.permute(0, 2, 3, 1).contiguous(), ref, sx.contiguous(),
            sy.contiguous(), cfg.reg3d_c))
    cor = fuse_frames(costs, weight_axis="depth")  # (B, D, h, w, G)
    with _models_ctx(cfg, cor.device):
        logits = models["reg3d"](cor.permute(0, 4, 1, 2, 3))
    cost_prob = torch.softmax(logits.float(), dim=1)
    depth_mvs = localmax(cost_prob, cfg.norm_radius, cfg.num_depth_bins,
                         1.0 / depth_bins[:, -1], 1.0 / depth_bins[:, 0])
    return depth_mvs, cost_prob


def _mono(models, color0, cfg: Config):
    with _models_ctx(cfg, color0.device):
        disps = models["mono_depth"](models["mono_encoder"](_nchw(color0)))
    return {k: v[:, 0].float() for k, v in disps.items()}  # (B, Hs, Ws)


@torch.no_grad()
def forward_infer(models, batch, cfg: Config):
    """Eval-protocol inference: mono disparity, MVS depth, cost probs.

    Raw frames, always-z-guided bins with a per-sample z-translation (the
    reference reads batch element 0 only), eval's depth-axis frame
    weighting. The batch carries only the matching frames, so frame
    indexing runs over ``matching_ids``.
    """
    cfg = cfg.replace(frame_ids=cfg.matching_ids)
    color = batch["color"]
    disps = _mono(models, color[:, 0], cfg)

    if cfg.load_pose or "relative_pose" in batch:
        rel = poses_from_batch(batch, cfg)
    else:
        rel = predict_poses(models, color, cfg)

    # one FPN call over all frames (exact at inference: running BN stats)
    b, m = color.shape[0], len(cfg.matching_ids)
    with _models_ctx(cfg, color.device):
        match_all, ctx_all = models["mvs_encoder"](
            _nchw(color[:, :m].reshape((b * m,) + color.shape[2:])))
    match_all = match_all.view((b, m) + match_all.shape[1:])
    ref_ctx = ctx_all.view((b, m) + ctx_all.shape[1:])[:, 0]

    _, depth_prior = disp_to_depth(disps[("disp", cfg.prior_scale)],
                                   cfg.min_depth, cfg.max_depth)
    z = cfg.z_scale * rel[:, 0, 2, 3]
    bins = schedule_depth_bins_z(depth_prior, cfg.num_depth_bins,
                                 cfg.depth_bin_fac, z[:, None, None],
                                 cfg.schedule_type)
    K_p = scale_intrinsics(batch["K"], cfg.prior_scale)
    depth_mvs, cost_prob = mvs_depth_from_features(
        models, match_all[:, 0], [match_all[:, i] for i in range(1, m)],
        bins, K_p, torch.linalg.inv(K_p), rel, cfg)

    if cfg.convex_up:
        with _models_ctx(cfg, color.device):
            up_mask = models["up"](ref_ctx)
        depth_mvs = convex_upsample(depth_mvs, up_mask.float(),
                                    cfg.prior_scale)
    scaled_disp_mono, _ = disp_to_depth(disps[("disp", 0)], cfg.min_depth,
                                        cfg.max_depth)
    return {
        "disp_mono": scaled_disp_mono,  # (B, H, W) scaled disparity
        "disp_mvs": 1.0 / depth_mvs,    # (B, H, W), or low-res without up
        "depth_mvs": depth_mvs,
        "cost_prob": cost_prob,         # (B, D, h, w)
    }


@torch.no_grad()
def forward_infer_fused(models, batch, cfg: Config):
    """forward_infer plus the learned mono/MVS blend: cost-volume entropy
    -> mask_cnn trust map -> blend at full resolution. Adds trust_mono,
    depth_fused and disp_fused, each (B, H, W)."""
    out = forward_infer(models, batch, cfg)
    h, w = batch["color"].shape[2:4]
    ent = entropy(out["cost_prob"], dim=1, keepdim=True)  # (B, 1, h, w)
    with _models_ctx(cfg, ent.device):
        trust = models["mask_cnn"](ent)
    trust_full = resize_bilinear(trust[:, 0].float(), (h, w),
                                 align_corners=True)
    depth_mvs = out["depth_mvs"]
    if depth_mvs.shape[-2:] != (h, w):  # convex_up off: bilinear
        depth_mvs = resize_bilinear(depth_mvs, (h, w), align_corners=True)
    mono_depth0 = 1.0 / out["disp_mono"]
    fused = (1.0 - trust_full) * depth_mvs + trust_full * mono_depth0
    return dict(out, trust_mono=trust_full, depth_fused=fused,
                disp_fused=1.0 / fused)


@torch.no_grad()
def forward_mono_infer(models, batch, cfg: Config):
    """Single-frame mono inference: scaled disparity and depth (B, H, W)."""
    disps = _mono(models, batch["color"][:, 0], cfg)
    scaled_disp, depth = disp_to_depth(disps[("disp", 0)], cfg.min_depth,
                                       cfg.max_depth)
    return {"disp_mono": scaled_disp, "depth_mono": depth}
