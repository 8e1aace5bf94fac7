"""Colored point-cloud export (PLY), a host-side debugging utility (port
of movedepth_tpu/ops/pointcloud.py, numpy as there): the same PLY bytes
for the same arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_PLY_HEADER = """ply
format ascii 1.0
element vertex {n}
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
property uchar alpha
end_header
"""


def generate_pointcloud(rgbs: Sequence[np.ndarray],
                        depths: Sequence[np.ndarray], ply_file: str,
                        intrs: Sequence[np.ndarray],
                        extrs: Sequence[np.ndarray],
                        masks: Sequence[np.ndarray]) -> str:
    """Backproject masked depth maps to world space and write an ASCII PLY.

    rgbs: (H, W, 3) uint8-ish; depths/masks: (H, W); intrs: (>=3, >=3);
    extrs: (4, 4) camera-to-world.
    """
    rows = []
    for rgb, depth, intr, extr, mask in zip(rgbs, depths, intrs, extrs,
                                            masks):
        h, w = depth.shape
        ys, xs = np.mgrid[0:h, 0:w]
        pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], 0)
        cam = np.linalg.inv(np.asarray(intr)[:3, :3]) @ (
            depth.reshape(1, -1) * pix)
        hom = np.vstack([cam, np.ones((1, h * w))])
        world = (np.asarray(extr) @ hom)[:3]
        keep = np.asarray(mask).reshape(-1) != 0
        pts = world[:, keep].T
        cols = np.asarray(rgb).reshape(-1, 3)[keep]
        for (x, y, z), (r, g, b) in zip(pts, cols):
            rows.append(f"{x:f} {y:f} {z:f} {int(r)} {int(g)} {int(b)} 0\n")
    with open(ply_file, "w") as f:
        f.write(_PLY_HEADER.format(n=len(rows)))
        f.writelines(rows)
    return ply_file
