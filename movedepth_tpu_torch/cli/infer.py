"""Depth prediction on a folder of video frames: the port's serving entry
point (port of movedepth_tpu/cli/infer.py).

  python -m movedepth_tpu_torch.cli.infer --image_path /path/to/frames \\
      --load_weights_folder /path/to/models/weights_19 --out_dir depth_out

Frames are read in sorted order as one video. Frame t gets the MVS depth
with frame t-1 as its matching frame, PoseNet supplying the relative pose;
the first frame gets the mono depth. ``--mono_only`` gives every frame the
mono depth, ``--fused`` the learned mono/MVS blend. Writes
``<name>_depth.npy`` (H, W) float32 metric depth per frame and, with
``--save_png``, ``<name>_disp.png``, the plasma-coloured disparity.
Intrinsics default to the normalized KITTI K at the processed size;
``--fx`` etc. (in pixels at that size) override them.

``--load_weights_folder`` is a reference folder of per-model ``.pth``
files (or a checkpoint folder of the port's trainer). An Orbax checkpoint
of the JAX package is converted first, where JAX is installed:
``python scripts/orbax_to_pth.py <orbax dir> <out dir>``, then
``--load_weights_folder <out dir>``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from movedepth_tpu_torch.cli.options import add_config_args, config_from_args
from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.ops.colormap import colormap
from movedepth_tpu_torch.train.checkpoints import check_loadable
from movedepth_tpu_torch.weights import load_reference_folder

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _normalized_kitti_K(h: int, w: int, fx=None, fy=None, cx=None, cy=None):
    """Pixel-space K at (h, w) from the normalized KITTI intrinsics."""
    K = np.array([[0.58 * w, 0, 0.5 * w, 0],
                  [0, 1.92 * h, 0.5 * h, 0],
                  [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    for (i, j), v in (((0, 0), fx), ((1, 1), fy), ((0, 2), cx), ((1, 2), cy)):
        if v is not None:
            K[i, j] = v
    return K


def _load_image(path: str, h: int, w: int) -> np.ndarray:
    img = Image.open(path).convert("RGB").resize((w, h), Image.LANCZOS)
    return np.asarray(img, np.float32) / 255.0


def load_models(cfg: Config, device):
    """The config's models with weights from ``cfg.load_weights_folder``."""
    folder = cfg.load_weights_folder
    if folder is None:
        raise SystemExit("--load_weights_folder is required")
    try:
        check_loadable(folder)
    except (OSError, ValueError) as e:
        raise SystemExit(str(e)) from None
    models = build_models(cfg, device)
    load_reference_folder(folder, {n: models[n] for n in cfg.models_to_load
                                   if n in models})
    return models


def _save_outputs(out_dir, name, depth, png: bool):
    np.save(os.path.join(out_dir, f"{name}_depth.npy"),
            depth.astype(np.float32))
    if png:
        disp = 1.0 / np.maximum(depth, 1e-6)
        rgb = (colormap(disp) * 255).astype(np.uint8).transpose(1, 2, 0)
        Image.fromarray(rgb).save(os.path.join(out_dir, f"{name}_disp.png"))


def run(cfg: Config, image_path: str, out_dir: str, mono: bool, device,
        K_override=None, fused: bool = False, png: bool = False):
    files = sorted(f for f in os.listdir(image_path)
                   if f.lower().endswith(IMG_EXTS))
    if not files:
        raise SystemExit(f"no images under {image_path}")
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device(device)
    models = load_models(cfg, device)
    h, w = cfg.height, cfg.width
    K = K_override if K_override is not None else _normalized_kitti_K(h, w)
    mvs_fn = P.forward_infer_fused if fused else P.forward_infer
    depth_key = "depth_fused" if fused else "depth_mvs"

    prev = None
    for i, fname in enumerate(files):
        img = _load_image(os.path.join(image_path, fname), h, w)
        name = os.path.splitext(fname)[0]
        # frames stacked in matching_ids order (0, -1): this one, then prev
        frames = [img] if mono or prev is None else [img, prev]
        batch = P.as_batch({"color": np.stack(frames)[None], "K": K[None],
                            "inv_K": np.linalg.inv(K)[None]}, device)
        if len(frames) == 1:
            depth = P.forward_mono_infer(models, batch, cfg)["depth_mono"]
        else:
            depth = mvs_fn(models, batch, cfg)[depth_key]
        depth = depth[0].float().cpu().numpy()
        _save_outputs(out_dir, name, depth, png)
        prev = img
        print(f"[{i + 1}/{len(files)}] {name}: "
              f"depth {depth.min():.2f}..{depth.max():.2f} m", flush=True)
    print(f"done -> {out_dir}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="MoveDepth inference "
                                                 "(PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--image_path", type=str, required=True,
                        help="folder of video frames (sorted order)")
    parser.add_argument("--out_dir", type=str, default="depth_out")
    parser.add_argument("--mono_only", action="store_true",
                        help="single-frame mono depth only")
    parser.add_argument("--fused", action="store_true",
                        help="emit the learned mono/MVS fused depth "
                             "(mask_cnn uncertainty blend)")
    parser.add_argument("--save_png", action="store_true",
                        help="also write a colormapped disparity PNG")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")
    for k in ("fx", "fy", "cx", "cy"):
        parser.add_argument(f"--{k}", type=float, default=None,
                            help=f"intrinsics {k} (pixels at processed res)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    K = None
    if any(getattr(args, k) is not None for k in ("fx", "fy", "cx", "cy")):
        K = _normalized_kitti_K(cfg.height, cfg.width, args.fx, args.fy,
                                args.cx, args.cy)
    run(cfg, args.image_path, args.out_dir, args.mono_only, args.device, K,
        fused=args.fused, png=args.save_png)


if __name__ == "__main__":
    main()
