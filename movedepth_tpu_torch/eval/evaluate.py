"""KITTI Eigen evaluation of the port (port of
movedepth_tpu/eval/evaluate.py; reference: movedepth/evaluate_depth.py).

Protocol constants: the 697-image eigen split, the crop [0.40810811H :
0.99189189H, 0.03594771W : 0.96405229W], per-image median scaling, depth
clamp [1e-3, 80] m; the 7 metrics for mono, MVS, the learned fusion and
the oracle "upbound" fusion.

The forwards run on the caller's device (``cuda`` unless it asks for the
CPU), one ``forward_infer_fused`` per batch, read back once per batch. The
per-image resize to the GT and the masked metrics (``ops.metrics``) stay
on the host. The JAX package resizes with OpenCV; the port, which runs where
OpenCV is absent, resizes with the same half-pixel bilinear rule in torch
(:func:`resize_depth`).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch.data.kitti import KITTIRawDataset, readlines
from movedepth_tpu_torch.data.loader import Loader
from movedepth_tpu_torch.data.splits import split_file
from movedepth_tpu_torch.ops.metrics import (METRIC_NAMES,
                                             compute_depth_errors,
                                             oracle_fuse_errors)

MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0


def resize_depth(depth: np.ndarray, shape) -> np.ndarray:
    """Bilinear resize of a (H, W) map to ``shape`` = (H, W) with
    half-pixel centres (the rule of OpenCV's INTER_LINEAR), in float64 for
    a float64 map (post-processed predictions), else in float32."""
    dtype = np.float64 if depth.dtype == np.float64 else np.float32
    t = torch.from_numpy(np.ascontiguousarray(depth, dtype))[None, None]
    return F.interpolate(t, size=tuple(shape), mode="bilinear",
                         align_corners=False)[0, 0].numpy()


def compute_errors_np(gt: np.ndarray, pred: np.ndarray):
    """The 7 metrics of masked vectors on the host, in METRIC_NAMES order
    (reference: evaluate_depth.py:22-40): ``ops.metrics`` on the arrays,
    in float64 when either is float64, as numpy computes them."""
    return _host(compute_depth_errors(torch.from_numpy(gt),
                                      torch.from_numpy(pred)))


def compute_fuse_errors_np(gt, pred_mono, pred_mvs):
    """Oracle best-of-two (reference: evaluate_depth.py:42-64)."""
    return _host(oracle_fuse_errors(*(torch.from_numpy(a) for a in
                                      (gt, pred_mono, pred_mvs))))


def _host(errors) -> np.ndarray:
    return np.array([errors[k].item() for k in METRIC_NAMES])


def batch_post_process_disparity(l_disp, r_disp):
    """monodepth-v1 flip post-processing
    (reference: evaluate_depth.py:67-75)."""
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    grid = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))[0]
    l_mask = (1.0 - np.clip(20 * (grid - 0.05), 0, 1))[None]
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + (1 - l_mask - r_mask) * m_disp


def eigen_mask(gt_depth: np.ndarray) -> np.ndarray:
    h, w = gt_depth.shape
    mask = (gt_depth > MIN_DEPTH) & (gt_depth < MAX_DEPTH)
    crop = np.array([0.40810811 * h, 0.99189189 * h,
                     0.03594771 * w, 0.96405229 * w]).astype(np.int32)
    crop_mask = np.zeros_like(mask)
    crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
    return mask & (crop_mask > 0)


def check_device(device) -> torch.device:
    """``device`` as a torch device; raises for ``cuda`` without a card
    (the trainer and the evaluation never move to the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card "
                           "unless it is given device='cpu'")
    return device


def _disparities(models, batch, cfg: Config, flip: bool):
    """(3, B, H, W) float32 on the host: mono, MVS and fused disparity of
    one forward, on frames mirrored along W and mirrored back with
    ``flip`` (K stays as it is, as in the JAX package)."""
    if flip:
        batch = dict(batch, color=batch["color"].flip(-2))
    out = P.forward_infer_fused(models, batch, cfg)
    disps = torch.stack([out["disp_mono"].float(),
                         1.0 / out["depth_mvs"].float(),
                         out["disp_fused"].float()])
    if flip:
        disps = disps.flip(-1)
    return disps.cpu().numpy()


def predict_disparities(models, cfg: Config, data_path: str,
                        split_dir: Optional[str] = None, batch_size: int = 1,
                        num_workers: int = 8, limit: Optional[int] = None,
                        device="cuda"):
    """Run full-MVS inference over the eval split's ``test_files.txt``
    (found by ``data.splits.split_file`` when ``split_dir`` is None).

    ``models`` must already sit on ``device`` (``cuda`` unless the caller
    asks for the CPU; without a card it raises). Returns
    (pred_disps_mono, pred_disps_mvs, pred_disps_fused) as (N, H, W) numpy
    arrays (reference: evaluate_depth.py:176-256); the fused channel is the
    learned mono/MVS blend. With ``cfg.post_process`` each batch also runs
    on mirrored frames and the two are blended by
    :func:`batch_post_process_disparity`.
    """
    device = check_device(device)
    filenames = readlines(split_file(cfg.eval_split, "test_files.txt",
                                     split_dir))
    if limit:
        filenames = filenames[:limit]
    img_ext = ".png" if cfg.png else ".jpg"
    dataset = KITTIRawDataset(
        data_path, filenames, cfg.height, cfg.width, cfg.matching_ids,
        is_train=False, img_ext=img_ext, load_depth=False)
    loader = Loader(dataset, batch_size, shuffle=False, drop_last=False,
                    num_workers=num_workers)

    monos, mvss, fuseds = [], [], []
    with torch.no_grad():
        for batch in loader.epoch(0):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()
                     if k in ("color", "K", "inv_K")}
            dm, dz, df = _disparities(models, batch, cfg, flip=False)
            if cfg.post_process:
                # monodepth-v1 flip blending; the reference parses the flag
                # but never applies it (SURVEY.md 2.2)
                dmf, dzf, dff = _disparities(models, batch, cfg, flip=True)
                dm = batch_post_process_disparity(dm, dmf)
                dz = batch_post_process_disparity(dz, dzf)
                df = batch_post_process_disparity(df, dff)
            monos.append(dm)
            mvss.append(dz)
            fuseds.append(df)
    return (np.concatenate(monos, 0), np.concatenate(mvss, 0),
            np.concatenate(fuseds, 0))


def evaluate_disparities(pred_disps_mono, pred_disps_mvs, gt_depths,
                         eval_split: str = "eigen",
                         disable_median_scaling: bool = False,
                         pred_depth_scale_factor: float = 1.0,
                         pred_disps_fused=None):
    """Host-side metric computation over predicted disparities.

    (reference: evaluate_depth.py:259-314)
    Returns dict with 'mono', 'mvs', 'upbound' 7-metric arrays, plus
    'fused' (the learned blend, same per-image protocol) when
    ``pred_disps_fused`` is given.
    """
    errs_mono, errs_mvs, errs_fuse, errs_learned = [], [], [], []
    for i in range(pred_disps_mono.shape[0]):
        gt = gt_depths[i]
        shape = gt.shape[:2]
        dm = resize_depth(pred_disps_mono[i], shape)
        dz = resize_depth(pred_disps_mvs[i], shape)
        pm = 1.0 / dm
        pz = 1.0 / dz

        mask = (eigen_mask(gt) if eval_split == "eigen" else gt > 0)
        pm, pz, g = pm[mask], pz[mask], gt[mask]
        pm *= pred_depth_scale_factor
        pz *= pred_depth_scale_factor
        if not disable_median_scaling:
            pm *= np.median(g) / np.median(pm)
            pz *= np.median(g) / np.median(pz)
        pm = np.clip(pm, MIN_DEPTH, MAX_DEPTH)
        pz = np.clip(pz, MIN_DEPTH, MAX_DEPTH)

        errs_mono.append(compute_errors_np(g, pm))
        errs_mvs.append(compute_errors_np(g, pz))
        errs_fuse.append(compute_fuse_errors_np(g, pm, pz))

        if pred_disps_fused is not None:
            df = resize_depth(pred_disps_fused[i], shape)
            pf = (1.0 / df)[mask] * pred_depth_scale_factor
            if not disable_median_scaling:
                pf *= np.median(g) / np.median(pf)
            pf = np.clip(pf, MIN_DEPTH, MAX_DEPTH)
            errs_learned.append(compute_errors_np(g, pf))

    results = {
        "mono": np.stack(errs_mono).mean(0),
        "mvs": np.stack(errs_mvs).mean(0),
        "upbound": np.stack(errs_fuse).mean(0),
    }
    if errs_learned:
        results["fused"] = np.stack(errs_learned).mean(0)
    return results


def print_tables(results: Dict[str, np.ndarray], file=None):
    """The metric tables, one per row of ``results``, as the JAX package
    prints them (to ``sys.stdout`` as it is at the call)."""
    file = file or sys.stdout
    for name in ("mono", "mvs", "fused", "upbound"):
        if name not in results:
            continue
        print(f"{name} results:", file=file)
        print(("{:>8} | " * 7).format(*METRIC_NAMES), file=file)
        print(("&{: 8.3f}  " * 7).format(*results[name].tolist()) + "\\\\",
              file=file)
        print("", file=file)


def load_gt_depths(gt_path: str):
    """The ``data`` object array of a ``gt_depths.npz``."""
    return np.load(gt_path, fix_imports=True, encoding="latin1",
                   allow_pickle=True)["data"]


def evaluate(models, cfg: Config, data_path: str,
             split_dir: Optional[str] = None, gt_path: Optional[str] = None,
             batch_size: int = 1, limit: Optional[int] = None,
             device="cuda", num_workers: int = 8) -> Dict[str, np.ndarray]:
    """Full protocol: inference + GT comparison + tables. ``gt_path``
    defaults to the split's ``gt_depths.npz``."""
    mono, mvs, fused = predict_disparities(models, cfg, data_path, split_dir,
                                           batch_size, num_workers, limit,
                                           device)
    gt_path = gt_path or split_file(cfg.eval_split, "gt_depths.npz",
                                    split_dir)
    gt = load_gt_depths(gt_path)
    if limit:
        gt = gt[:limit]
    results = evaluate_disparities(mono, mvs, gt, cfg.eval_split,
                                   cfg.disable_median_scaling,
                                   cfg.pred_depth_scale_factor,
                                   pred_disps_fused=fused)
    print_tables(results)
    return results
