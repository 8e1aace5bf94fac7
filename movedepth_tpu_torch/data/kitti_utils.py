"""KITTI calibration and velodyne ground-truth utilities (host-side numpy),
a copy of ``movedepth_tpu/data/kitti_utils.py``: the velodyne depth map
and a minimal odometry-pose reader."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI calib file into {key: float array or string}."""
    data: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.asarray(
                    [float(v) for v in value.split()], dtype=np.float64)
            except ValueError:
                data[key] = value
    return data


def load_velodyne_points(path: str) -> np.ndarray:
    """(N, 4) homogeneous lidar points (x fwd, y left, z up, 1)."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def generate_depth_map(calib_dir: str, velo_path: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Project velodyne points into camera ``cam``; nearest-point wins.

    Matches the reference pipeline (reference: movedepth/kitti_utils.py:44-96)
    including the KITTI-matlab ``round - 1`` pixel convention, but resolves
    duplicate pixels with a vectorized lexsort (~100x faster than the
    reference's Python Counter loop). Deviation: the reference's sub2ind
    uses ``row*(W-1)+col-1`` which aliases (y, W-1) with (y+1, 0), merging
    those two border pixels' minima; here every pixel gets its true min.
    The affected pixels lie outside the eigen evaluation crop.
    """
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_f = read_calib_file(
        os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.eye(4)
    velo2cam[:3, :3] = velo2cam_f["R"].reshape(3, 3)
    velo2cam[:3, 3] = velo2cam_f["T"]

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)  # (H, W)

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = P_rect @ R_rect @ velo2cam

    velo = load_velodyne_points(velo_path)
    velo = velo[velo[:, 0] >= 0]  # drop points behind the image plane

    pts_im = (P_velo2im @ velo.T).T
    pts_im[:, :2] /= pts_im[:, 2:3]
    if vel_depth:
        pts_im[:, 2] = velo[:, 0]

    # KITTI matlab convention: round then -1
    xs = np.round(pts_im[:, 0]) - 1
    ys = np.round(pts_im[:, 1]) - 1
    valid = (xs >= 0) & (ys >= 0) & (xs < im_shape[1]) & (ys < im_shape[0])
    xs, ys, zs = xs[valid].astype(np.int64), ys[valid].astype(np.int64), \
        pts_im[valid, 2]

    depth = np.zeros(tuple(im_shape), dtype=np.float64)
    # duplicate pixels: keep the minimum depth (vectorized)
    lin = ys * im_shape[1] + xs
    order = np.lexsort((zs, lin))
    lin, zs = lin[order], zs[order]
    first = np.ones(len(lin), dtype=bool)
    first[1:] = lin[1:] != lin[:-1]
    depth.reshape(-1)[lin[first]] = zs[first]
    depth[depth < 0] = 0
    return depth


def load_odometry_poses(pose_file: str) -> np.ndarray:
    """Read a KITTI-odometry-style pose file: rows of 12 floats -> (N,4,4).

    Replaces the pykitti dependency for the DVSO-pose (load_pose) mode
    (reference: datasets/mono_dataset.py:96-101 loads ``poses_dvso/<seq>``).
    """
    rows = np.loadtxt(pose_file).reshape(-1, 12)
    n = rows.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, :3, :4] = rows.reshape(n, 3, 4)
    return poses
