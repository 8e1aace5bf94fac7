"""Pinhole camera geometry on tensors (port of movedepth_tpu/ops/geometry.py).

Conventions as in the JAX package: pixel coordinate order (x, y);
intrinsics K and rigid transforms T are 4x4 homogeneous matrices batched on
leading dims; normalized sampling grids are in [-1, 1] with
align_corners=True semantics.
"""

from __future__ import annotations

import torch


def disp_to_depth(disp, min_depth, max_depth):
    """Sigmoid disparity -> (scaled_disp, depth).

    depth = 1 / (1/max_depth + disp * (1/min_depth - 1/max_depth)).
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def rot_from_axisangle(vec):
    """Axis-angle (..., 3) -> homogeneous rotation matrix (..., 4, 4)."""
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    c1 = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xc, yc, zc = x * c1, y * c1, z * c1
    xyc, yzc, zxc = x * yc, y * zc, z * xc
    zero = torch.zeros_like(ca)
    one = torch.ones_like(ca)
    rot = torch.stack([
        x * xc + ca, xyc - zs, zxc + ys, zero,
        xyc + zs, y * yc + ca, yzc - xs, zero,
        zxc - ys, yzc + xs, z * zc + ca, zero,
        zero, zero, zero, one,
    ], dim=-1)
    return rot.reshape(rot.shape[:-1] + (4, 4))


def get_translation_matrix(t):
    """Translation vector (..., 3) -> homogeneous matrix (..., 4, 4)."""
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(
        t.shape[:-1] + (1, 1))
    T[..., :3, 3] = t
    return T


def transformation_from_parameters(axisangle, translation, invert=False):
    """(axis-angle, translation), each (..., 3) -> 4x4 camera-to-camera
    transform: M = T @ R, or with ``invert`` R^T @ T(-t)."""
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(-1, -2)
        t = -t
    T = get_translation_matrix(t)
    return R @ T if invert else T @ R


def transformation_from_parameters_v2(axisangle, translation, invert=False):
    """Per-pixel transforms: a global axis-angle (B, 3) and a dense
    translation field (B, H, W, 3) -> (B, H, W, 4, 4), each pixel's
    T @ R (or with ``invert`` R^T @ T(-t))."""
    R = rot_from_axisangle(axisangle)[:, None, None]  # (B, 1, 1, 4, 4)
    t = translation
    if invert:
        R = R.transpose(-1, -2)
        t = -t
    T = get_translation_matrix(t)  # (B, H, W, 4, 4)
    return R @ T if invert else T @ R


def project_per_pixel(points, K, T, eps=1e-7):
    """Project camera points (B, 4, H*W) through per-pixel transforms T
    (B, H, W, 4, 4) and K (B, 4, 4) -> normalized grid (B, H, W, 2)."""
    b, h, w = T.shape[0], T.shape[1], T.shape[2]
    P = (K[:, None, None] @ T)[..., :3, :]  # (B, H, W, 3, 4)
    pts = points.transpose(-1, -2).reshape(b, h, w, 4, 1)
    cam = (P @ pts)[..., 0]  # (B, H, W, 3)
    xy = cam[..., :2] / (cam[..., 2:3] + eps)
    x = xy[..., 0] / (w - 1)
    y = xy[..., 1] / (h - 1)
    return (torch.stack([x, y], dim=-1) - 0.5) * 2.0


def pixel_grid(height, width, dtype=torch.float32, device=None):
    """Homogeneous pixel grid (3, H*W) with rows (x, y, 1)."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones_like(xs).reshape(-1)]).to(dtype)


def backproject(depth, inv_K):
    """Depth (..., H, W) and inv_K (..., 4, 4) -> camera points (..., 4, H*W)."""
    h, w = depth.shape[-2], depth.shape[-1]
    pix = pixel_grid(h, w, depth.dtype, depth.device)
    rays = inv_K[..., :3, :3] @ pix  # (..., 3, HW)
    cam = depth.reshape(depth.shape[:-2] + (1, h * w)) * rays
    ones = torch.ones(cam.shape[:-2] + (1, h * w), dtype=cam.dtype,
                      device=cam.device)
    return torch.cat([cam, ones], dim=-2)


def project_pixel(points, K, T, height, width, eps=1e-7):
    """:func:`project` in pixel coordinates: (sx, sy), each (..., H, W),
    the align_corners=True pixel positions that ``project`` normalizes."""
    P = (K @ T)[..., :3, :]
    cam = P @ points  # (..., 3, HW)
    xy = cam[..., :2, :] / (cam[..., 2:3, :] + eps)
    shape = xy.shape[:-2] + (height, width)
    return xy[..., 0, :].reshape(shape), xy[..., 1, :].reshape(shape)


def project(points, K, T, height, width, eps=1e-7):
    """Project homogeneous points (..., 4, H*W) into a camera -> normalized
    grid (..., H, W, 2) in [-1, 1] (align_corners=True convention)."""
    sx, sy = project_pixel(points, K, T, height, width, eps)
    return (torch.stack([sx / (width - 1), sy / (height - 1)], dim=-1)
            - 0.5) * 2.0
