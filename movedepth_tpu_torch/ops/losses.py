"""Self-supervised photometric losses (port of the NHWC functions of
movedepth_tpu/ops/losses.py).

Images and per-pixel maps keep the JAX package's NHWC layout at every
public function: images (B, H, W, C), loss maps (B, H, W, 1). The JAX
package's folded-planar variants are a TPU layout and have no counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from movedepth_tpu_torch.parallel.dist import all_reduce_sum


def entropy(volume, dim, keepdim=False):
    """Shannon entropy of a probability volume along ``dim``."""
    clamped = torch.clamp(volume, 1e-9, 1.0)
    return torch.sum(-volume * torch.log(clamped), dim=dim, keepdim=keepdim)


def _ssim_terms(x, y):
    """SSIM's numerator and denominator over 3x3 VALID windows of NCHW
    images."""
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2

    def pool(t):
        return F.avg_pool2d(t, 3, 1)

    mu_x = pool(x)
    mu_y = pool(y)
    sigma_x = pool(x * x) - mu_x * mu_x
    sigma_y = pool(y * y) - mu_y * mu_y
    sigma_xy = pool(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    return ssim_n, ssim_d


def ssim(x, y):
    """Structural dissimilarity map clamp((1 - SSIM) / 2, 0, 1) of NHWC
    images in [0, 1]: reflection padding by 1, then 3x3 mean pooling."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    yp = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    ssim_n, ssim_d = _ssim_terms(xp, yp)
    out = torch.clamp((1 - ssim_n / ssim_d) / 2, 0.0, 1.0)
    return out.permute(0, 2, 3, 1)


def mvs_ssim(x, y, mask):
    """Masked SSIM without padding, over VALID 3x3 windows, of NHWC images
    x, y (B, H, W, C) and a mask (B, H, W, 1) -> (the dissimilarity map
    times the pooled mask (B, H-2, W-2, C), the pooled mask (B, H-2, W-2,
    1))."""
    ssim_n, ssim_d = _ssim_terms(x.permute(0, 3, 1, 2),
                                 y.permute(0, 3, 1, 2))
    pooled = F.avg_pool2d(mask.to(x.dtype).permute(0, 3, 1, 2), 3, 1)
    out = pooled * torch.clamp((1 - ssim_n / ssim_d) / 2, 0.0, 1.0)
    return out.permute(0, 2, 3, 1), pooled.permute(0, 2, 3, 1)


def reprojection_loss(pred, target, ssim_lw=0.85, use_ssim=True):
    """Per-pixel photometric loss (B, H, W, 1): ``ssim_lw * SSIM +
    (1 - ssim_lw) * L1``, both averaged over channels."""
    l1 = torch.mean(torch.abs(target - pred), dim=-1, keepdim=True)
    if not use_ssim:
        return l1
    s = torch.mean(ssim(pred, target), dim=-1, keepdim=True)
    return ssim_lw * s + (1.0 - ssim_lw) * l1


def smooth_loss(disp, img):
    """Edge-aware first-order smoothness, a scalar. disp: (B, H, W, 1);
    img: (B, H, W, C)."""
    dx = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    dy = torch.abs(disp[:, :-1] - disp[:, 1:])
    ix = torch.mean(torch.abs(img[:, :, :-1] - img[:, :, 1:]), -1,
                    keepdim=True)
    iy = torch.mean(torch.abs(img[:, :-1] - img[:, 1:]), -1, keepdim=True)
    return torch.mean(dx * torch.exp(-ix)) + torch.mean(dy * torch.exp(-iy))


def smooth_l1_loss(pred, target, beta=1.0):
    """Elementwise smooth-L1 (Huber) with mean reduction, as
    ``F.smooth_l1_loss``."""
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta,
                                  d - 0.5 * beta))


def min_reprojection_with_automask(reproj_losses, identity_losses, noise):
    """monodepth2 min-reprojection with identity automasking.

    reproj_losses, identity_losses: (B, H, W, N) per source frame; noise:
    (B, H, W, 1) standard normal tiebreak, added times 1e-5 to the identity
    minimum. Returns (min_reproj, mask), each (B, H, W, 1); mask is 1
    where the reprojection beats the identity.
    """
    reproj = torch.amin(reproj_losses, dim=-1, keepdim=True)
    ident = torch.amin(identity_losses, dim=-1, keepdim=True) + noise * 1e-5
    return reproj, (reproj <= ident).to(reproj.dtype)


def masked_mean(x, mask, eps=1e-7, group=None):
    """sum(x * mask) / (sum(mask) + eps).

    With a process ``group``, both sums run over the global batch of every
    rank (one all-reduce of the packed pair through ``all_reduce_sum``), so
    every rank holds the value the JAX package computes on the global batch
    under its mesh; a mean of per-rank ratios would differ whenever the
    ranks' mask counts do. Gradient scale: every rank seeds the same global
    value, and the all-reduce's backward sums the cotangents of all ranks,
    so each rank's gradient is ``world`` times its share of the global
    value's; ``parallel.dist.all_reduce_grads`` divides the sum of the
    ranks' gradients by ``world`` and restores the gradient of the global
    mean, as it does for the plain means, which each rank takes over its
    own rows."""
    if group is None:
        return torch.sum(x * mask) / (torch.sum(mask) + eps)
    sums = all_reduce_sum(torch.stack([torch.sum(x * mask), torch.sum(mask)]),
                          group)
    return sums[0] / (sums[1] + eps)
