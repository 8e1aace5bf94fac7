"""Host-side KITTI datasets producing pipeline-layout samples: a copy of
``movedepth_tpu/data/kitti.py``.

Samples are numpy dicts in the pipeline's NHWC layout (no batch
dimension); the randomness of a sample is a ``np.random.Generator`` drawn
from (seed, epoch, index), so the same tree and seed give the JAX
package's samples. Two paths read the images:

  * ``native=True`` (the trainer's default, ``native_loader``): the C++
    loader (``data/native_loader.py``, ``csrc/loader.cpp``) decodes, flips
    and builds the chained float Lanczos pyramid, and jittered samples get
    the fused float jitter in C++, drawn from the same rng positions as
    the PIL jitter. A loader that cannot be built raises; the dataset
    never switches to PIL on its own. Robust training's random neighbour
    offsets read natively too (the JAX package reads them with PIL); a
    sample whose frame 0 or both neighbours are missing goes to the PIL
    path, which raises its own error. ``native_items`` counts the samples
    the C++ loader made;
  * ``native=False``: PIL decode, Lanczos resizes in uint8 and the PIL
    jitter.

The velodyne depth map is resized to the full KITTI resolution by
:func:`resize_nearest` (OpenCV's INTER_NEAREST rule in numpy), so the
port needs no OpenCV.
"""

from __future__ import annotations

import gzip
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image, ImageEnhance

from movedepth_tpu_torch.data import native_loader
from movedepth_tpu_torch.data.kitti_utils import (generate_depth_map,
                                                  load_odometry_poses)

_LANCZOS = Image.Resampling.LANCZOS
_NEAREST = Image.Resampling.NEAREST

# normalized KITTI intrinsics
K_NORM = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    dtype=np.float32,
)
FULL_RES = (1242, 375)  # (W, H)
SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}


def readlines(path: str) -> List[str]:
    """Read a split list; falls back to a gzipped copy at ``path + .gz``."""
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        with gzip.open(path + ".gz", "rt") as f:
            return f.read().splitlines()
    with open(path) as f:
        return f.read().splitlines()


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """Nearest-neighbour resize of (H, W[, C]) to ``size`` = (W, H), as
    OpenCV's INTER_NEAREST picks: source index floor(i / (dst / src)),
    capped at the last row or column."""
    out_w, out_h = size
    in_h, in_w = img.shape[:2]

    def index(n_out, n_in):
        scale = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64),
                          n_in - 1)

    return img[index(out_h, in_h)[:, None], index(out_w, in_w)[None, :]]


def color_jitter(rng: np.random.Generator):
    """Sample a torchvision-ColorJitter-equivalent callable on PIL images:
    factors in [0.8, 1.2], hue in [-0.1, 0.1], random op order."""
    b = rng.uniform(0.8, 1.2)
    c = rng.uniform(0.8, 1.2)
    s = rng.uniform(0.8, 1.2)
    h = rng.uniform(-0.1, 0.1)
    ops = list(rng.permutation(4))

    def hue_shift(img: Image.Image) -> Image.Image:
        hsv = np.array(img.convert("HSV"), dtype=np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(h * 255)) % 256
        return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

    def apply(img: Image.Image) -> Image.Image:
        for op in ops:
            if op == 0:
                img = ImageEnhance.Brightness(img).enhance(b)
            elif op == 1:
                img = ImageEnhance.Contrast(img).enhance(c)
            elif op == 2:
                img = ImageEnhance.Color(img).enhance(s)
            else:
                img = hue_shift(img)
        return img

    return apply


def _rgb_to_hsv_np(arr: np.ndarray):
    """Vectorized float RGB->HSV on (H, W, 3) in [0, 1]."""
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    v = arr.max(-1)
    c = v - arr.min(-1)
    safe_c = np.where(c == 0, 1.0, c)
    h = np.where(
        v == r, (g - b) / safe_c,
        np.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    h = np.where(c == 0, 0.0, h / 6.0) % 1.0
    s = np.where(v == 0, 0.0, c / np.where(v == 0, 1.0, v))
    return h, s, v


def _hsv_to_rgb_np(h, s, v):
    """Vectorized float HSV->RGB, inverse of :func:`_rgb_to_hsv_np`."""
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.choose(
        i[..., None],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out


def color_jitter_np(rng: np.random.Generator):
    """Float counterpart of :func:`color_jitter` on [0, 1] float images.

    Draws the same (b, c, s, h, op order) from the same rng positions as
    the PIL version, then applies the math in float32: brightness x*b;
    contrast blends toward the luma mean; saturation blends toward
    per-pixel luma (ITU-R 601-2, PIL's convert('L')); hue rotates in
    float HSV by int(h*255)/255, mod 1. It differs from the PIL path only
    by PIL's uint8 rounding after every op."""
    params, ops = draw_jitter_params(rng)
    return _apply_jitter_np(params, ops)


def draw_jitter_params(rng: np.random.Generator):
    """The shared (b, c, s, h) factors and op order, drawn from the same
    rng positions as :func:`color_jitter`, so PIL, numpy and the C++
    ``md_jitter_batch`` see the same parameters."""
    b = rng.uniform(0.8, 1.2)
    c = rng.uniform(0.8, 1.2)
    s = rng.uniform(0.8, 1.2)
    h = rng.uniform(-0.1, 0.1)
    ops = list(rng.permutation(4))
    return (b, c, s, h), ops


def _apply_jitter_np(params, ops):
    b, c, s, h = params
    luma_w = np.array([0.299, 0.587, 0.114], np.float32)

    def apply(arr: np.ndarray) -> np.ndarray:
        arr = arr.astype(np.float32)
        for op in ops:
            if op == 0:
                arr = arr * b
            elif op == 1:
                # PIL blends toward the rounded mean of the L image; the
                # float mean is the same up to that rounding
                mean = (arr @ luma_w).mean()
                arr = mean * (1.0 - c) + arr * c
            elif op == 2:
                l = (arr @ luma_w)[..., None]
                arr = l * (1.0 - s) + arr * s
            else:
                # PIL adds int(h*255) to the uint8 hue (mod 256); here the
                # same fraction of a turn
                hh, ss, vv = _rgb_to_hsv_np(np.clip(arr, 0.0, 1.0))
                hh = (hh + int(h * 255) / 255.0) % 1.0
                arr = _hsv_to_rgb_np(hh, ss, vv)
            arr = np.clip(arr, 0.0, 1.0)
        return arr

    return apply


def _to_float(img: Image.Image) -> np.ndarray:
    return np.asarray(img, dtype=np.float32) / 255.0


class KITTIRawDataset:
    """KITTI raw sequences; velodyne GT when present.

    Produces per-sample dicts (no batch dim):
      color (F, H, W, 3), color_aug (F, H, W, 3), color_pyr_{1,2,3},
      K (4,4), inv_K (4,4) [, depth_gt (375, 1242)] [, relative_pose].
    """

    num_pyramid_scales = 4

    def __init__(self, data_path: str, filenames: Sequence[str], height: int,
                 width: int, frame_ids: Sequence[int], is_train: bool = False,
                 img_ext: str = ".jpg", load_depth: Optional[bool] = None,
                 load_pose: bool = False, seed: int = 1,
                 native: bool = False, rt: bool = False):
        self.data_path = data_path
        # the C++ loader, built at first use; raises where it cannot be
        self.native = native_loader.get() if native else None
        self.native_items = 0
        self._count_lock = threading.Lock()  # the Loader's threads count
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.is_train = is_train
        self.img_ext = img_ext
        self.seed = seed
        self.epoch = 0
        self.load_pose = load_pose
        # robust training: random neighbour offsets from {-3..-1, 1..3}
        self.rt = rt
        self.load_depth = (self.check_depth() if load_depth is None
                           else load_depth)
        self._poses = {}
        if load_pose:
            self._load_dvso_poses()

    # -- path helpers ---------------------------------------------------------

    def parse_line(self, index: int):
        parts = self.filenames[index].split()
        folder = parts[0]
        frame_index = int(parts[1]) if len(parts) == 3 else 0
        side = parts[2] if len(parts) == 3 else None
        return folder, frame_index, side

    def image_path(self, folder: str, frame_index: int, side: str) -> str:
        fname = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder,
                            f"image_0{SIDE_MAP[side]}", "data", fname)

    def check_depth(self) -> bool:
        if not self.filenames:
            return False
        folder, frame_index, _ = self.parse_line(0)
        velo = os.path.join(self.data_path, folder, "velodyne_points",
                            "data", f"{frame_index:010d}.bin")
        return os.path.isfile(velo)

    def get_depth(self, folder, frame_index, side, do_flip) -> np.ndarray:
        calib = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(self.data_path, folder, "velodyne_points",
                            "data", f"{int(frame_index):010d}.bin")
        depth = generate_depth_map(calib, velo, SIDE_MAP[side])
        depth = resize_nearest(depth, FULL_RES)
        if do_flip:
            depth = np.fliplr(depth)
        return depth.astype(np.float32)

    def _load_dvso_poses(self):
        seqs = (["01", "02", "06", "08", "09", "10"] if self.is_train
                else ["00", "04", "05", "07"])
        for s in seqs:
            path = os.path.join(self.data_path, "poses_dvso", f"{s}.txt")
            if os.path.isfile(path):
                self._poses[s] = load_odometry_poses(path)

    # -- main -----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.filenames)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index]))

    def _load_frame(self, folder, frame_index, side, do_flip):
        img = Image.open(
            self.image_path(folder, frame_index, side)).convert("RGB")
        if do_flip:
            img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        return img

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = self._rng(index)
        do_aug = self.is_train and rng.random() > 0.5
        do_flip = (self.is_train and rng.random() > 0.5
                   and not self.load_pose)
        folder, frame_index, side = self.parse_line(index)

        offsets = {i: i for i in self.frame_ids}
        if self.is_train and self.rt:
            draws = rng.choice([-3, -2, -1, 1, 2, 3],
                               size=len(self.frame_ids) - 1, replace=False)
            for i, off in zip(self.frame_ids[1:], draws):
                offsets[i] = int(off)

        if self.native is not None:
            sample = self._getitem_native(folder, frame_index, side, do_flip,
                                          rng if do_aug else None, offsets)
            if sample is not None:
                with self._count_lock:
                    self.native_items += 1
                return sample

        frames: Dict[int, Image.Image] = {}
        rel_poses: Dict[int, np.ndarray] = {}
        for i in self.frame_ids:
            try:
                frames[i] = self._load_frame(folder,
                                             frame_index + offsets[i], side,
                                             do_flip)
                if self.load_pose:
                    seq = f"{int(folder):02d}"
                    poses = self._poses[seq]
                    rel_poses[i] = (
                        np.linalg.inv(poses[frame_index + i])
                        @ poses[frame_index]
                    ).astype(np.float32)
            except (FileNotFoundError, OSError):
                # missing neighbour: duplicate the adjacent frame
                if i > 0:
                    frames[i] = frames[i - 1]
                elif i < 0:
                    frames[i] = frames[i + 1]
                    if self.load_pose:
                        rel_poses[i] = np.eye(4, dtype=np.float32)
                else:
                    raise

        jitter = color_jitter(rng) if do_aug else (lambda im: im)

        # chained Lanczos pyramid: scale i is resized from scale i-1
        color = []
        color_aug = []
        pyr: Dict[int, np.ndarray] = {}
        for i in self.frame_ids:
            img = frames[i].resize((self.width, self.height), _LANCZOS)
            arr = _to_float(img)
            color.append(arr)
            # blank frames stay blank
            color_aug.append(arr if arr.sum() == 0 else _to_float(jitter(img)))
            if i == 0:
                prev = img
                for s in range(1, self.num_pyramid_scales):
                    prev = prev.resize(
                        (self.width // 2 ** s, self.height // 2 ** s),
                        _LANCZOS)
                    pyr[s] = _to_float(prev)

        K = K_NORM.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height

        sample: Dict[str, np.ndarray] = {
            "color": np.stack(color, 0),
            "color_aug": np.stack(color_aug, 0),
            "K": K,
            "inv_K": np.linalg.inv(K).astype(np.float32),
        }
        for s, arr in pyr.items():
            sample[f"color_pyr_{s}"] = arr
        if self.load_depth:
            sample["depth_gt"] = self.get_depth(folder, frame_index, side,
                                                do_flip)
        if self.load_pose:
            sample["relative_pose"] = np.stack(
                [rel_poses[i] for i in self.frame_ids[1:]], 0)
        return sample

    def _getitem_native(self, folder, frame_index, side, do_flip,
                        aug_rng=None, offsets=None):
        """The C++ loader's sample, or None for the PIL path (frame 0 or
        both neighbours of a frame missing), where PIL raises its own
        errors.

        ``offsets`` maps each frame id to the offset it reads (robust
        training's draw; default: the id itself). A missing frame takes
        the frame of id i-1 (i > 0) or i+1 (i < 0) at that id's offset, as
        the PIL path duplicates it. ``aug_rng`` non-None jitters the
        scale-0 frames for ``color_aug``: it is the sample's generator at
        the position where the PIL path draws its jitter, so both draw the
        same (b, c, s, h, order)."""
        offsets = offsets or {i: i for i in self.frame_ids}
        paths = []
        for i in self.frame_ids:
            p = self.image_path(folder, frame_index + offsets[i], side)
            if not os.path.isfile(p):  # duplicate the adjacent frame
                j = i - 1 if i > 0 else i + 1
                p = self.image_path(folder, frame_index + offsets.get(j, j),
                                    side)
                if i == 0 or not os.path.isfile(p):
                    return None
            paths.append(p)
        # one call for every frame: frame 0's pyramid is slot 0 of each
        # scale (the others' coarse scales are cheap and unused)
        pyr = self.native.load_batch(paths, self.width, self.height,
                                     self.num_pyramid_scales,
                                     [do_flip] * len(paths))
        scale0 = pyr[0]

        if aug_rng is not None:
            params, ops = draw_jitter_params(aug_rng)
            jittered = self.native.jitter_batch(scale0.copy(), params, ops)
            # blank frames stay blank (the jitter keeps 0 at 0 already)
            color_aug = np.stack(
                [f if f.sum() == 0 else j for f, j in zip(scale0, jittered)],
                0)
        else:
            color_aug = scale0

        K = K_NORM.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        sample = {
            "color": scale0,
            "color_aug": color_aug,
            "K": K,
            "inv_K": np.linalg.inv(K).astype(np.float32),
        }
        for s in range(1, self.num_pyramid_scales):
            sample[f"color_pyr_{s}"] = pyr[s][0]
        if self.load_depth:
            sample["depth_gt"] = self.get_depth(folder, frame_index, side,
                                                do_flip)
        if self.load_pose:
            seq = f"{int(folder):02d}"
            poses = self._poses[seq]
            rel = []
            for i in self.frame_ids[1:]:
                try:
                    rel.append((np.linalg.inv(poses[frame_index + i])
                                @ poses[frame_index]).astype(np.float32))
                except IndexError:
                    rel.append(np.eye(4, dtype=np.float32))
            sample["relative_pose"] = np.stack(rel, 0)
        return sample


class KITTIOdomDataset(KITTIRawDataset):
    """KITTI odometry layout."""

    def image_path(self, folder, frame_index, side):
        fname = f"{frame_index:06d}{self.img_ext}"
        return os.path.join(self.data_path,
                            f"sequences/{int(folder):02d}",
                            f"image_{SIDE_MAP[side]}", fname)

    def check_depth(self) -> bool:
        return False


class KITTIDepthDataset(KITTIRawDataset):
    """Annotated-GT variant: depth from ``proj_depth/groundtruth`` PNGs."""

    def get_depth(self, folder, frame_index, side, do_flip):
        path = os.path.join(
            self.data_path, folder,
            f"proj_depth/groundtruth/image_0{SIDE_MAP[side]}",
            f"{frame_index:010d}.png")
        depth = Image.open(path).resize(FULL_RES, _NEAREST)
        depth = np.asarray(depth, dtype=np.float32) / 256.0
        if do_flip:
            depth = np.fliplr(depth)
        return depth
