"""The masked-augmentation box mask and the forward-backward geometric
consistency mask (port of movedepth_tpu/ops/masking.py)."""

from __future__ import annotations

import torch

from movedepth_tpu_torch.ops.geometry import pixel_grid
from movedepth_tpu_torch.ops.image_warp import warp_images_border_reference


def sample_box(height, width, filter_size, generator=None, device="cuda"):
    """A box position (x0, y0), uniform in [0, W-fw) x [0, R-fh), drawn
    from ``generator`` (torch's default one if None) on ``device``, the
    card unless the caller asks for the CPU. The JAX package draws it with
    ``jax.random``; tests inject its draw."""
    fh, fw = filter_size
    x0 = torch.randint(0, width - fw, (), generator=generator, device=device)
    y0 = torch.randint(0, height - fh, (), generator=generator, device=device)
    return int(x0), int(y0)


def random_image_mask(img, filter_size, box):
    """Zero out one (fh, fw) box at ``box`` = (x0, y0), shared across the
    batch. img: (B, H, W, C). Returns (masked_img, mask), mask 0 inside the
    box and 1 outside, broadcast to img's shape; (img, None) when the box
    covers the whole image."""
    fh, fw = filter_size
    _, h, w, _ = img.shape
    if (fh, fw) == (h, w):
        return img, None
    x0, y0 = box
    mask = torch.ones((h, w), dtype=img.dtype, device=img.device)
    mask[y0:y0 + fh, x0:x0 + fw] = 0.0
    mask = mask[None, :, :, None].expand(img.shape)
    return img * mask, mask


def geometric_consistency_mask(depth_ref, K_ref, T_ref2src, depth_src, K_src,
                               pixel_thres=1.0, depth_thres=0.1, eps=1e-10):
    """Forward-backward reprojection consistency, bool (B, H, W).

    depth_ref/depth_src: (B, H, W); K_*: (B, 4, 4) (the 3x3 block is
    used); T_ref2src: (B, 4, 4). A pixel passes when its reprojected
    position error is below ``pixel_thres`` and its relative depth error
    below ``depth_thres``. The source depth is sampled in border mode
    (align_corners=True) through the plain image warp.
    """
    b, h, w = depth_ref.shape
    K3_ref, K3_src = K_ref[:, :3, :3], K_src[:, :3, :3]
    pix = pixel_grid(h, w, depth_ref.dtype, depth_ref.device)

    xyz_ref = torch.linalg.inv(K3_ref) @ (pix[None]
                                          * depth_ref.reshape(b, 1, -1))
    ones = torch.ones((b, 1, h * w), dtype=depth_ref.dtype,
                      device=depth_ref.device)
    xyz_src = (T_ref2src @ torch.cat([xyz_ref, ones], 1))[:, :3]
    k_xyz_src = K3_src @ xyz_src
    xy_src = k_xyz_src[:, :2] / (k_xyz_src[:, 2:3] + eps)  # (B, 2, HW)

    # through the normalized grid and back, as grid_sample does
    gx = xy_src[:, 0] / ((w - 1) / 2.0) - 1.0
    gy = xy_src[:, 1] / ((h - 1) / 2.0) - 1.0
    sx = ((gx + 1.0) * 0.5 * (w - 1)).reshape(b, 1, h, w)
    sy = ((gy + 1.0) * 0.5 * (h - 1)).reshape(b, 1, h, w)
    sampled = warp_images_border_reference(depth_src[..., None], sx, sy)

    xyz_src2 = torch.linalg.inv(K3_src) @ (
        torch.cat([xy_src, ones], 1) * sampled.reshape(b, 1, -1))
    xyz_rep = (torch.linalg.inv(T_ref2src)
               @ torch.cat([xyz_src2, ones], 1))[:, :3]
    depth_rep = xyz_rep[:, 2].reshape(b, h, w)
    k_xyz_rep = K3_ref @ xyz_rep
    xy_rep = k_xyz_rep[:, :2] / (k_xyz_rep[:, 2:3] + eps)
    x_rep = xy_rep[:, 0].reshape(b, h, w)
    y_rep = xy_rep[:, 1].reshape(b, h, w)

    dist = torch.sqrt((x_rep - pix[0].reshape(h, w)) ** 2
                      + (y_rep - pix[1].reshape(h, w)) ** 2)
    rel_diff = torch.abs(depth_rep - depth_ref) / depth_ref
    return (dist < pixel_thres) & (rel_diff < depth_thres)
