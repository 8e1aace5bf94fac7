"""Optical-flow visualization (Baker et al. color wheel) and the flow
update (port of movedepth_tpu/ops/flowvis.py): host-side numpy for
debugging, as in the JAX package; ``update_flow`` takes torch tensors or
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def make_colorwheel() -> np.ndarray:
    """(55, 3) color wheel (Baker et al., ICCV 2007)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    ramps = [
        (ry, 0, 1, False), (yg, 1, 0, True), (gc, 1, 2, False),
        (cb, 2, 1, True), (bm, 2, 0, False), (mr, 0, 2, True),
    ]
    for n, hold, ramp, down in ramps:
        wheel[col:col + n, hold] = 255
        grad = np.floor(255 * np.arange(n) / n)
        wheel[col:col + n, ramp] = 255 - grad if down else grad
        col += n
    return wheel


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Normalized flow components -> (H, W, 3) uint8 visualization."""
    img = np.zeros((u.shape[0], u.shape[1], 3), np.uint8)
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        inside = rad <= 1
        col[inside] = 1 - rad[inside] * (1 - col[inside])
        col[~inside] = col[~inside] * 0.75
        img[:, :, 2 - i if convert_to_bgr else i] = np.floor(255 * col)
    return img


def flow_to_image(flow_uv: np.ndarray, clip_flow=None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 image."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad_max = np.sqrt(u ** 2 + v ** 2).max()
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps),
                             convert_to_bgr)


def update_flow(flow, pix_coords, width, height):
    """Normalized grid coordinates (B, H, W, 2) -> pixel coordinates,
    added to a flow field (B, H, W, 2): torch tensors give a tensor, numpy
    arrays an array."""
    pix = pix_coords / 2.0 + 0.5
    px = pix[..., 0] * (width - 1)
    py = pix[..., 1] * (height - 1)
    if isinstance(px, torch.Tensor):
        return torch.stack([px, py], dim=-1) + flow
    return np.stack([px, py], axis=-1) + flow
