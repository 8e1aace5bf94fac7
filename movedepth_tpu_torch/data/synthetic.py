"""Synthetic batches in the pipeline's batch layout (a copy of
``movedepth_tpu/data/synthetic.py``): smooth procedural frames and the
normalized KITTI intrinsics, for tests and smoke runs without KITTI."""

from __future__ import annotations

from typing import Dict

import numpy as np

from movedepth_tpu_torch.config import Config


def kitti_intrinsics(height: int, width: int) -> np.ndarray:
    """Scale-0 4x4 K from the normalized KITTI intrinsics."""
    K = np.array(
        [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32,
    )
    K[0, :] *= width
    K[1, :] *= height
    return K


def make_batch(cfg: Config, batch_size: int, seed: int = 0,
               with_pose: bool = False) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    h, w = cfg.height, cfg.width
    f = len(cfg.frame_ids)

    # smooth random images: low-res noise upsampled (keeps SSIM sane)
    def smooth_images(shape_hw, n):
        small = rng.uniform(0, 1, (n, shape_hw[0] // 8, shape_hw[1] // 8, 3))
        img = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)
        return img.astype(np.float32)

    color = smooth_images((h, w), batch_size * f).reshape(batch_size, f, h, w,
                                                          3)
    batch = {
        "color": color,
        "color_aug": np.clip(
            color + rng.normal(0, 0.01, color.shape).astype(np.float32), 0, 1),
        "K": np.tile(kitti_intrinsics(h, w), (batch_size, 1, 1)),
        "inv_K": np.tile(np.linalg.inv(kitti_intrinsics(h, w)),
                         (batch_size, 1, 1)).astype(np.float32),
    }
    for s in range(1, 4):
        batch[f"color_pyr_{s}"] = color[:, 0, ::2 ** s, ::2 ** s]
    if with_pose:
        rel = np.tile(np.eye(4, dtype=np.float32), (batch_size, f - 1, 1, 1))
        rel[:, :, 2, 3] = rng.uniform(0.01, 0.1, (batch_size, f - 1))
        batch["relative_pose"] = rel
    return batch
