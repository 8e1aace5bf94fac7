"""Typed configuration of the port: a copy of ``movedepth_tpu/config.py``.

Every field keeps the JAX package's name and default, so an ``opt.json``
written by either package loads in the other. Some fields steer only the
TPU formulation (scoped-VMEM limits, kernel windows, the planar loss
layout); the port accepts them and reads the ones it implements.
``native_loader`` selects the port's own C++ loader, as it does the JAX
package's. The TPU-only helpers of the JAX module
(``xla_compiler_options``, ``KERNEL_TIERS``) are not copied.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

ALL_MODELS: Tuple[str, ...] = (
    "mono_encoder",
    "mono_depth",
    "pose_encoder",
    "pose",
    "mvs_encoder",
    "reg3d",
    "mask_cnn",
    "up",
)


@dataclass(frozen=True)
class Config:
    # ---- data ----
    data_path: str = "kitti_data"
    log_dir: str = "log"
    model_name: str = "mdp"
    split: str = "eigen_zhou"
    dataset: str = "kitti"
    png: bool = False
    height: int = 192
    width: int = 640

    # ---- model architecture ----
    res_arch: int = 18  # ResNet depth of the mono and pose encoders
    weights_init: str = "pretrained"  # "pretrained" | "scratch"
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    prior_scale: int = 2  # scale of the mono disparity used as MVS prior
    reg3d_c: int = 16  # cost-volume group count == Reg3D channels
    convex_up: bool = True
    dcn: bool = False  # deformable FPN head

    # ---- depth range / cost volume ----
    min_depth: float = 0.1
    max_depth: float = 100.0
    num_depth_bins: int = 16
    depth_bin_fac: float = 0.3
    schedule_type: str = "inverse"  # 'inverse' | 'linear' | 'log'
    ztrans_start_epc: int = 8
    z_scale: float = 30.0
    norm_radius: int = 1

    # ---- frames ----
    frame_ids: Tuple[int, ...] = (0, -1, 1)
    matching_ids: Tuple[int, ...] = (0, -1)

    # ---- optimization ----
    batch_size: int = 12
    learning_rate: float = 1e-4
    lr_fac: float = 1.0  # LR multiplier of the MVS parameter group
    num_epochs: int = 20
    scheduler_step_size: int = 15  # StepLR x0.1 every this many epochs
    seed: int = 1

    # ---- losses ----
    ssim_lw: float = 0.85
    disparity_smoothness: float = 1e-3
    mask_lw: float = 10.0  # masked-augmentation consistency weight
    no_ssim: bool = False
    disable_automasking: bool = False
    avg_reprojection: bool = False
    mask_mvs_conf: bool = False
    mask_mvs_dist: bool = False
    mask_mvs_geo: bool = False
    mask_mvs_auto: bool = False
    mvs_smooth_loss: bool = False
    photo_conf: float = 0.2
    dist_thres: float = 0.0
    pixel_thres: float = 1.0
    depth_thres: float = 0.1

    # ---- pose ----
    load_pose: bool = False  # precomputed DVSO poses instead of PoseNet

    # ---- system ----
    num_workers: int = 12
    compute_dtype: str = "bfloat16"  # autocast dtype of the models
    # parameter storage type; BatchNorm running statistics stay float32
    param_dtype: str = "float32"
    pallas_warp: bool = True  # JAX package only
    sweep_row_window: int = 8  # JAX package only
    sweep_col_window: int = 0  # JAX package only
    warp_col_window: int = 384  # JAX package only
    # the C++ loader (csrc/loader.cpp): decode, float Lanczos pyramid and
    # jitter; off: PIL
    native_loader: bool = True
    planar_losses: bool = False  # JAX package only
    # the photometric L1 map from the image-warp kernel's epilogue
    kernel_l1: bool = False
    fold_stage2: bool = False  # JAX package only
    # train batches (per card) above this rematerialize the MVS trunk and
    # the photometric frame blocks (torch.utils.checkpoint)
    remat_batch_threshold: int = 24
    # > 1: train steps per dispatch, a CUDA graph of one step replayed on
    # the card (train/state.py make_train_multistep)
    steps_per_dispatch: int = 1
    scoped_vmem_limit_kib: int = 32768  # JAX package only
    infer_scoped_vmem_limit_kib: int = 40960  # JAX package only
    # "full": the encoders rematerialize too; "mvs": the blocks above only
    remat_scope: str = "full"
    robust_train: bool = False  # random frame offsets in training
    model_shard_axis: str = "groups"  # JAX package only

    # ---- loading ----
    load_weights_folder: Optional[str] = None
    mono_weights_folder: Optional[str] = None
    models_to_load: Tuple[str, ...] = ALL_MODELS

    # ---- logging ----
    log_frequency: int = 250
    save_frequency: int = 1
    save_intermediate_models: bool = False

    # ---- evaluation ----
    eval_split: str = "eigen"
    disable_median_scaling: bool = False
    pred_depth_scale_factor: float = 1.0
    post_process: bool = False

    # -------------------------------------------------------------- helpers
    @property
    def num_scales(self) -> int:
        return len(self.scales)

    @property
    def prior_hw(self) -> Tuple[int, int]:
        s = 2 ** self.prior_scale
        return self.height // s, self.width // s

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        """The experiment config as ``opt.json`` holds it."""
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        for k in ("scales", "frame_ids", "matching_ids", "models_to_load"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        return Config(**d)


def validate(cfg: Config) -> Config:
    """Shape and consistency checks of a training config."""
    if cfg.height % 32 != 0:
        raise ValueError("height must be a multiple of 32")
    if cfg.width % 32 != 0:
        raise ValueError("width must be a multiple of 32")
    if cfg.frame_ids[0] != 0:
        raise ValueError("frame_ids must start with 0")
    if len(cfg.frame_ids) <= 1:
        raise ValueError("frame_ids must have more than 1 frame")
    if cfg.matching_ids[0] != 0:
        raise ValueError("matching_ids must start with 0")
    if cfg.res_arch not in (18, 34, 50, 101, 152):
        raise ValueError("res_arch must be one of 18/34/50/101/152")
    if cfg.schedule_type not in ("inverse", "linear", "log"):
        raise ValueError("unknown schedule_type")
    return cfg
