"""MOVEDepth's inference and training forward in plain PyTorch, frozen
for the benchmark: the yardstick that decides ``correct``.

It follows the reference repository's equations as the program ports
them (the same layouts, stop-gradients and constants) with the shipped
options only: z-guided inverse-depth bins, one source frame at inference,
convex upsampling, the mono/MVS/fused/masked losses with automasking and
no optional MVS masks. Where the program has CUDA kernels this file calls
``F.grid_sample`` (align_corners=True): zeros padding for the plane-sweep
warp, border padding for the photometric warp. Everything runs in float32
with TF32 off (:func:`float32`); nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32():
    """TF32 off for matrix products and convolutions inside the block,
    the previous settings back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------- geometry

def disp_to_depth(disp, min_depth, max_depth):
    lo, hi = 1.0 / max_depth, 1.0 / min_depth
    scaled = lo + (hi - lo) * disp
    return scaled, 1.0 / scaled


def rot_from_axisangle(vec):
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca, sa = torch.cos(angle)[..., 0], torch.sin(angle)[..., 0]
    c1 = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero, one = torch.zeros_like(ca), torch.ones_like(ca)
    rot = torch.stack([
        x * x * c1 + ca, x * y * c1 - z * sa, z * x * c1 + y * sa, zero,
        x * y * c1 + z * sa, y * y * c1 + ca, y * z * c1 - x * sa, zero,
        z * x * c1 - y * sa, y * z * c1 + x * sa, z * z * c1 + ca, zero,
        zero, zero, zero, one], dim=-1)
    return rot.reshape(rot.shape[:-1] + (4, 4))


def transformation_from_parameters(axisangle, translation, invert=False):
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R, t = R.transpose(-1, -2), -t
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(
        t.shape[:-1] + (1, 1))
    T[..., :3, 3] = t
    return R @ T if invert else T @ R


def pixel_grid(h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones_like(xs).reshape(-1)]).float()


def backproject(depth, inv_K):
    h, w = depth.shape[-2:]
    rays = inv_K[..., :3, :3] @ pixel_grid(h, w, depth.device)
    cam = depth.reshape(depth.shape[:-2] + (1, h * w)) * rays
    return torch.cat([cam, torch.ones_like(cam[..., :1, :])], dim=-2)


def project(points, K, T, h, w, eps=1e-7):
    """Homogeneous points (..., 4, HW) -> normalized grid (..., H, W, 2)."""
    cam = (K @ T)[..., :3, :] @ points
    xy = cam[..., :2, :] / (cam[..., 2:3, :] + eps)
    shape = xy.shape[:-2] + (h, w)
    gx = xy[..., 0, :].reshape(shape) / (w - 1)
    gy = xy[..., 1, :].reshape(shape) / (h - 1)
    return (torch.stack([gx, gy], dim=-1) - 0.5) * 2.0


def scale_intrinsics(K, scale):
    K = K.clone()
    K[..., 0:2, :] *= 1.0 / (2 ** scale)
    return K


def resize(img, hw, align_corners):
    """Bilinear resize of (B, C, H, W) or (B, H, W)."""
    if tuple(img.shape[-2:]) == tuple(hw):
        return img
    if img.dim() == 3:
        return resize(img[:, None], hw, align_corners)[:, 0]
    return F.interpolate(img, size=tuple(hw), mode="bilinear",
                         align_corners=align_corners)


# ---------------------------------------------------------------- cost volume

def z_bins(prior_depth, ndepth, fac, z):
    """Inverse-depth bins (B, D, h, w) in [prior/(1+fac z), prior(1+fac z)],
    bin 0 the farthest."""
    prior_depth = prior_depth.detach()
    z = z.detach()[:, None, None]
    lo = (prior_depth / (1.0 + fac * z))[:, None]
    hi = (prior_depth * (1.0 + fac * z))[:, None]
    itv = torch.arange(ndepth, device=lo.device, dtype=lo.dtype)[
        None, :, None, None] / (ndepth - 1)
    return 1.0 / (1.0 / hi + (1.0 / lo - 1.0 / hi) * itv)


def sweep_grid(bins, K, inv_K, T, eps=1e-7):
    """Normalized grid (B, D, h, w, 2) of every depth hypothesis in the
    source camera (no gradient)."""
    b, d, h, w = bins.shape
    rays = inv_K[:, :3, :3] @ pixel_grid(h, w, bins.device)
    pts = bins.reshape(b, d, 1, h * w) * rays[:, None]
    P = (K @ T)[:, :3, :]
    cam = (torch.einsum("bij,bdjp->bdip", P[:, :, :3], pts)
           + P[:, :, 3:4][:, None])
    xy = cam[:, :, :2] / (cam[:, :, 2:3] + eps)
    gx = (xy[:, :, 0] / (w - 1) - 0.5) * 2.0
    gy = (xy[:, :, 1] / (h - 1) - 0.5) * 2.0
    return torch.stack([gx, gy], dim=-1).reshape(b, d, h, w, 2).detach()


def sweep_warp(src, grid):
    """Zeros-padded warp of src (B, C, h, w) over the grid (B, D, h, w, 2)
    -> (B, C, D, h, w)."""
    b, d, h, w, _ = grid.shape
    out = F.grid_sample(src, grid.reshape(b, d * h, w, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.view(b, src.shape[1], d, h, w)


def group_mean(cost, groups):
    """(B, C, D, h, w) -> (B, G, D, h, w): group g is the mean of channels
    k*G+g."""
    b, c = cost.shape[:2]
    return cost.reshape((b, c // groups, groups) + cost.shape[2:]).mean(1)


def fuse_frames(costs, axis):
    """Confidence-weighted fusion of per-frame volumes (B, G, D, h, w):
    a frame's weight is the max of a softmax over G of the depth-mean
    ('group', training) or over D of the group-mean ('depth', eval)."""
    wsum, acc = 1e-8, 0.0
    for cost in costs:
        if axis == "group":
            wgt = torch.softmax(cost.mean(dim=2), dim=1).amax(dim=1)
        else:
            wgt = torch.softmax(cost.mean(dim=1), dim=1).amax(dim=1)
        wsum = wsum + wgt
        acc = acc + wgt[:, None, None] * cost
    return acc / wsum[:, None, None]


def localmax(prob, radius, ndepth, inv_min, inv_max):
    idx0 = torch.argmax(prob, dim=1, keepdim=True)
    iota = torch.arange(ndepth, device=prob.device)[None, :, None, None]
    cnt = 0
    for o in range(-radius, radius + 1):
        cnt = cnt + (iota == torch.clamp(idx0 + o, 0, ndepth - 1))
    wprob = prob * cnt.to(prob.dtype)
    num = torch.sum(iota.to(prob.dtype) * wprob, dim=1)
    norm = num / (1e-6 + torch.sum(wprob, dim=1)) / (ndepth - 1)
    return 1.0 / (inv_min + norm * (inv_max - inv_min))


def convex_upsample(depth, mask, scale):
    s = 2 ** scale
    b, h, w = depth.shape
    wts = torch.softmax(mask.view(b, 9, s, s, h, w), dim=1)
    taps = F.unfold(depth[:, None], kernel_size=3, padding=1)
    up = torch.sum(wts * taps.view(b, 9, 1, 1, h, w), dim=1)
    return up.permute(0, 3, 1, 4, 2).reshape(b, h * s, w * s)


def entropy(prob, dim):
    return torch.sum(-prob * torch.log(torch.clamp(prob, 1e-9, 1.0)),
                     dim=dim, keepdim=True)


# ---------------------------------------------------------------- models

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _pose(models, color, idx, f, invert):
    """The camera transform of frame ``f`` (index ``idx`` of ``color`` (B,
    F, H, W, 3)) against frame 0, from PoseNet."""
    pair = (color[:, idx], color[:, 0])
    if f > 0:
        pair = pair[::-1]
    feats = models["pose_encoder"](_nchw(torch.cat(pair, dim=-1)))
    aa, tr = models["pose"](feats)
    return transformation_from_parameters(aa[:, 0, 0], tr[:, 0, 0], invert)


def _mono(models, color0):
    disps = models["mono_depth"](models["mono_encoder"](_nchw(color0)))
    return {k: v[:, 0] for k, v in disps.items()}


@torch.no_grad()
def forward_infer_fused(models, color, K, cfg, stats=None):
    """Eval inference of frames (B, 2, H, W, 3) in (0, -1) order and K
    (B, 4, 4): disp_mono, depth_mvs, cost_prob, trust_mono and
    depth_fused, float32. ``stats`` (a dict), if given, gets the share of
    plane-sweep samples that fall inside the source frame."""
    b, m, h, w = color.shape[:4]
    if m != 2 or tuple(cfg.matching_ids) != (0, -1):
        raise ValueError("the reference infers from frames (0, -1)")
    disps = _mono(models, color[:, 0])
    rel = _pose(models, color, 1, -1, invert=True)  # (B, 4, 4)
    match, ctx = models["mvs_encoder"](
        _nchw(color.reshape((b * m,) + color.shape[2:])))
    match = match.view((b, m) + match.shape[1:])
    ref_ctx = ctx.view((b, m) + ctx.shape[1:])[:, 0]
    _, prior = disp_to_depth(disps[("disp", cfg.prior_scale)], cfg.min_depth,
                             cfg.max_depth)
    bins = z_bins(prior, cfg.num_depth_bins, cfg.depth_bin_fac,
                  cfg.z_scale * rel[:, 2, 3])
    K_p = scale_intrinsics(K, cfg.prior_scale)
    grid = sweep_grid(bins, K_p, torch.linalg.inv(K_p), rel)
    if stats is not None:
        inside = (grid.abs() <= 1.0).all(dim=-1).float().mean().item()
        stats.setdefault("in_frame", []).append(inside)
    cost = group_mean(sweep_warp(match[:, 1], grid) * match[:, 0][:, :, None],
                      cfg.reg3d_c)
    cost = fuse_frames([cost], "depth")
    prob = torch.softmax(models["reg3d"](cost), dim=1)
    depth_mvs = localmax(prob, cfg.norm_radius, cfg.num_depth_bins,
                         1.0 / bins[:, -1], 1.0 / bins[:, 0])
    depth_mvs = convex_upsample(depth_mvs, models["up"](ref_ctx),
                                cfg.prior_scale)
    disp_mono, _ = disp_to_depth(disps[("disp", 0)], cfg.min_depth,
                                 cfg.max_depth)
    trust = resize(models["mask_cnn"](entropy(prob, 1))[:, 0], (h, w), True)
    fused = (1.0 - trust) * depth_mvs + trust / disp_mono
    return {"disp_mono": disp_mono, "depth_mvs": depth_mvs,
            "cost_prob": prob, "trust_mono": trust, "depth_fused": fused}


# ---------------------------------------------------------------- losses

def ssim(x, y):
    """(1 - SSIM) / 2 of NHWC images, reflection padding, 3x3 means."""
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = F.avg_pool2d(x, 3, 1), F.avg_pool2d(y, 3, 1)
    sx = F.avg_pool2d(x * x, 3, 1) - mx * mx
    sy = F.avg_pool2d(y * y, 3, 1) - my * my
    sxy = F.avg_pool2d(x * y, 3, 1) - mx * my
    n = (2 * mx * my + c1) * (2 * sxy + c2)
    d = (mx * mx + my * my + c1) * (sx + sy + c2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0).permute(0, 2, 3, 1)


def reprojection(pred, target, ssim_lw):
    l1 = torch.mean(torch.abs(target - pred), dim=-1, keepdim=True)
    s = torch.mean(ssim(pred, target), dim=-1, keepdim=True)
    return ssim_lw * s + (1.0 - ssim_lw) * l1


def smooth_loss(disp, img):
    dx = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    dy = torch.abs(disp[:, :-1] - disp[:, 1:])
    ix = torch.mean(torch.abs(img[:, :, :-1] - img[:, :, 1:]), -1, True)
    iy = torch.mean(torch.abs(img[:, :-1] - img[:, 1:]), -1, True)
    return torch.mean(dx * torch.exp(-ix)) + torch.mean(dy * torch.exp(-iy))


def masked_mean(x, mask):
    return torch.sum(x * mask) / (torch.sum(mask) + 1e-7)


def _check_train_options(cfg):
    off = ("kernel_l1", "no_ssim", "disable_automasking", "avg_reprojection",
           "mask_mvs_conf", "mask_mvs_dist", "mask_mvs_geo", "mask_mvs_auto",
           "mvs_smooth_loss", "load_pose", "dcn")
    on = [k for k in off if getattr(cfg, k)]
    if on or not cfg.convex_up or tuple(cfg.matching_ids) != (0, -1):
        raise ValueError(f"the reference trains the shipped options only; "
                         f"got {on}")


def forward_train(models, batch, cfg, draws):
    """The training forward at z-guided bins (the models in train mode):
    (total loss, {the four loss terms}). ``batch`` holds color, color_aug
    (B, 3, H, W, 3) in frames (0, -1, 1) order, color_pyr_1..3, K, inv_K;
    ``draws`` the box (x0, y0) and one automask noise map per scale."""
    _check_train_options(cfg)
    aug, color = batch["color_aug"], batch["color"]
    h, w = cfg.height, cfg.width
    idx = {f: i for i, f in enumerate(cfg.frame_ids)}
    cam = {f: _pose(models, aug, idx[f], f, invert=f < 0)
           for f in cfg.frame_ids[1:]}
    rel = cam[-1].detach()
    ref_match, ref_ctx = models["mvs_encoder"](_nchw(aug[:, 0]))
    src_match = models["mvs_encoder"](_nchw(aug[:, idx[-1]]))[0]
    disps = _mono(models, aug[:, 0])
    _, mono_depth0 = disp_to_depth(resize(disps[("disp", 0)], (h, w), False),
                                   cfg.min_depth, cfg.max_depth)
    _, prior = disp_to_depth(disps[("disp", cfg.prior_scale)].detach(),
                             cfg.min_depth, cfg.max_depth)
    bins = z_bins(prior, cfg.num_depth_bins, cfg.depth_bin_fac,
                  cfg.z_scale * rel[:, 2, 3])
    K_p = scale_intrinsics(batch["K"], cfg.prior_scale)

    fh, fw = h // 3, w // 3
    x0, y0 = draws["box"]
    xs = torch.arange(w, device=aug.device)
    ys = torch.arange(h, device=aug.device)[:, None]
    inside = (xs >= x0) & (xs < x0 + fw) & (ys >= y0) & (ys < y0 + fh)
    keep = (~inside).float()  # (H, W)
    masked = aug[:, 0] * keep[None, :, :, None]
    ref_aug = models["mvs_encoder"](_nchw(masked))[0]

    warped = sweep_warp(src_match.float(),
                        sweep_grid(bins, K_p, torch.linalg.inv(K_p), rel))
    depths = []
    for ref in (ref_match, ref_aug):
        cost = fuse_frames([group_mean(warped * ref[:, :, None], cfg.reg3d_c)],
                           "group")
        prob = torch.softmax(models["reg3d"](cost), dim=1)
        depths.append((localmax(prob, cfg.norm_radius, cfg.num_depth_bins,
                                1.0 / bins[:, -1], 1.0 / bins[:, 0]), prob))
    (depth_mvs, prob), (depth_aug, _) = depths
    trust = models["mask_cnn"](entropy(prob, 1))
    low = resize(keep[None, None].expand(aug.shape[0], 3, h, w),
                 depth_aug.shape[1:], True)
    low = (low.sum(dim=1) > 0).float()
    diff = torch.abs(depth_aug - depth_mvs)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    masked = masked_mean(sl1, low) * cfg.mask_lw ** 2
    depth_full = convex_upsample(depth_mvs, models["up"](ref_ctx),
                                 cfg.prior_scale)
    trust_full = resize(trust[:, 0], (h, w), True)
    fused = ((1.0 - trust_full) * depth_full.detach()
             + trust_full * mono_depth0.detach())

    losses = photometric(disps, depth_full, fused, batch, cam, cfg,
                         iter(draws["noise"]))
    losses["masked_loss"] = masked
    total = (losses["mono_loss"] + masked + losses["mvs_loss"]
             + losses["fuse_reproj_loss"])
    return total, losses


def photometric(disps, depth_mvs, fused, batch, cam, cfg, noise):
    color = batch["color"]
    target = color[:, 0]
    b, h, w = target.shape[:3]
    idx = {f: i for i, f in enumerate(cfg.frame_ids)}
    nsc = len(cfg.scales)
    k_all = nsc + 2
    depth = [disp_to_depth(resize(disps[("disp", s)], (h, w), False),
                           cfg.min_depth, cfg.max_depth)[1]
             for s in cfg.scales]
    pts = backproject(torch.stack(depth + [depth_mvs, fused], dim=1),
                      batch["inv_K"][:, None])
    mono_rp, mvs_rp, fuse_l1 = [], [], []
    for f in cfg.frame_ids[1:]:
        T = torch.stack([cam[f]] * nsc + [cam[f].detach()] * 2, dim=1)
        grid = project(pts, batch["K"][:, None], T, h, w)  # (B, K, H, W, 2)
        src = color[:, idx[f]].permute(0, 3, 1, 2)
        warped = F.grid_sample(src, grid.reshape(b, k_all * h, w, 2),
                               mode="bilinear", padding_mode="border",
                               align_corners=True)
        wf = warped.view(b, 3, k_all, h, w).permute(0, 2, 3, 4, 1).reshape(
            b * k_all, h, w, 3)
        tf = target[:, None].expand(b, k_all, h, w, 3).reshape(wf.shape)
        l1 = torch.mean(torch.abs(tf - wf), dim=-1, keepdim=True)
        rp = (cfg.ssim_lw * torch.mean(ssim(wf, tf), dim=-1, keepdim=True)
              + (1.0 - cfg.ssim_lw) * l1).view(b, k_all, h, w, 1)
        l1 = l1.view(b, k_all, h, w, 1)
        mono_rp.append(rp[:, :nsc])
        mvs_rp.append(rp[:, nsc])
        fuse_l1.append(l1[:, nsc + 1])

    ident = torch.cat([reprojection(color[:, idx[f]], target, cfg.ssim_lw)
                       for f in cfg.frame_ids[1:]], dim=-1)
    losses, total = {}, 0.0
    for k, s in enumerate(cfg.scales):
        rps = torch.cat([m[:, k] for m in mono_rp], dim=-1)
        reproj = torch.amin(rps, dim=-1, keepdim=True)
        tie = torch.amin(ident, dim=-1, keepdim=True) + next(noise) * 1e-5
        rl = masked_mean(reproj, (reproj <= tie).float())
        disp = disps[("disp", s)][..., None]
        img = target if s == 0 else batch[f"color_pyr_{s}"]
        sl = smooth_loss(disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7),
                         img)
        total = total + rl + cfg.disparity_smoothness * sl / (2 ** s)
    losses["mono_loss"] = total / nsc
    ones = torch.ones_like(mvs_rp[0])
    losses["mvs_loss"] = masked_mean(
        torch.amin(torch.cat(mvs_rp, dim=-1), dim=-1, keepdim=True), ones)
    losses["fuse_reproj_loss"] = masked_mean(
        torch.amin(torch.cat(fuse_l1, dim=-1), dim=-1, keepdim=True), ones)
    return losses


# ---------------------------------------------------------------- Adam

MVS_GROUP = ("mask_cnn", "mvs_encoder", "reg3d")


class Adam:
    """Adam written out (betas 0.9, 0.999, eps 1e-8, bias-corrected), the
    MVS models' parameters at ``learning_rate * lr_fac``."""

    def __init__(self, models, cfg):
        self.params = [(p, cfg.learning_rate * (cfg.lr_fac if name in
                                                MVS_GROUP else 1.0))
                       for name in sorted(models)
                       for p in models[name].parameters()]
        self.m = [torch.zeros_like(p) for p, _ in self.params]
        self.v = [torch.zeros_like(p) for p, _ in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for (p, lr), m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(0.9).add_(p.grad, alpha=0.1)
            v.mul_(0.999).addcmul_(p.grad, p.grad, value=0.001)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + 1e-8))
