"""Export the ground-truth depths of an eval split to a ``gt_depths.npz``
(port of movedepth_tpu/eval/export_gt.py; reference:
movedepth/export_gt_depth.py:11-53)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image

from movedepth_tpu_torch.data.kitti import readlines
from movedepth_tpu_torch.data.kitti_utils import generate_depth_map
from movedepth_tpu_torch.data.splits import split_file


def export_gt_depths(data_path: str, split: str, out_path: str,
                     split_dir: Optional[str] = None) -> str:
    """Write the GT depth of every line of ``split``'s ``test_files.txt``
    (found by ``data.splits.split_file``) to ``out_path``: the projected
    velodyne scan for 'eigen', the ``proj_depth`` PNG for
    'eigen_benchmark'. Returns ``out_path``."""
    if split not in ("eigen", "eigen_benchmark"):
        raise ValueError("split must be eigen or eigen_benchmark")
    lines = readlines(split_file(split, "test_files.txt", split_dir))
    gt_depths = []
    for line in lines:
        folder, frame_id, _ = line.split()
        frame_id = int(frame_id)
        if split == "eigen":
            calib_dir = os.path.join(data_path, folder.split("/")[0])
            velo = os.path.join(data_path, folder, "velodyne_points/data",
                                f"{frame_id:010d}.bin")
            gt = generate_depth_map(calib_dir, velo, 2, vel_depth=True)
        else:
            png = os.path.join(data_path, folder, "proj_depth", "groundtruth",
                               "image_02", f"{frame_id:010d}.png")
            gt = np.asarray(Image.open(png), dtype=np.float32) / 256.0
        gt_depths.append(gt.astype(np.float32))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    # force a 1-D object array even when all GTs share a shape (a plain
    # np.array(..., dtype=object) would build a 3-D array of scalars)
    arr = np.empty(len(gt_depths), dtype=object)
    for i, g in enumerate(gt_depths):
        arr[i] = g
    np.savez_compressed(out_path, data=arr)
    return out_path
