"""Training orchestrator of the port: epoch loop, validation, logging and
checkpoints (port of movedepth_tpu/train/trainer.py).

The models, the data, the optimizer and the randomness live in one
process on one device: ``cuda`` unless the caller asks for ``cpu``.
Randomness comes from two explicit ``torch.Generator``s: the weights from
one seeded with ``cfg.seed`` (``build_models``), the masked-augmentation
boxes and automask noise of every train and validation forward from one on
the device seeded with ``cfg.seed + 1`` (``pipeline.sample_draws``). The
data loader draws its own augmentation from (seed, epoch, index), as the
JAX package's does.

Checkpoints are reference ``.pth`` folders plus ``adam.pth``
(train/checkpoints.py), saved every ``save_frequency`` epochs and always as
``last``. Resuming from a folder with ``adam.pth`` continues the step
clock: the epoch, the z-guided bins and the learning-rate schedule go on
where the saved run left off. A reference folder without it starts at step
0. Distributed training and the multi-step dispatch are not ported
(ROADMAP).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch import weights as W
from movedepth_tpu_torch.config import Config, validate
from movedepth_tpu_torch.data.kitti import (KITTIDepthDataset,
                                            KITTIOdomDataset,
                                            KITTIRawDataset, readlines)
from movedepth_tpu_torch.data.loader import Loader
from movedepth_tpu_torch.data.splits import split_file
from movedepth_tpu_torch.eval.evaluate import (check_device,
                                                compute_errors_np,
                                                resize_depth)
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.train import checkpoints as C
from movedepth_tpu_torch.train import state as S
from movedepth_tpu_torch.train.logging import MetricsLogger

DATASETS = {
    "kitti": KITTIRawDataset,
    "kitti_odom": KITTIOdomDataset,
    "kitti_depth": KITTIDepthDataset,
}
MONO_MODELS = ("pose_encoder", "pose", "mono_encoder", "mono_depth")
GARG_SHAPE = (375, 1242)


def garg_depth_metrics(depth_pred: np.ndarray, depth_gt: np.ndarray) -> Dict:
    """During-training GT metrics with the Garg crop at 375x1242, median
    scaled: abs_rel, sq_rel, rms, log_rms and the three accuracies."""
    names = ["de/abs_rel", "de/sq_rel", "de/rms", "de/log_rms", "da/a1",
             "da/a2", "da/a3"]
    accs = []
    for i in range(depth_pred.shape[0]):
        pred = np.clip(resize_depth(depth_pred[i], GARG_SHAPE), 1e-3,
                       80)
        gt = depth_gt[i]
        mask = (gt > 1e-3) & (gt < 80)
        crop = np.zeros_like(mask)
        crop[153:371, 44:1197] = True
        mask &= crop
        if mask.sum() == 0:
            continue
        p, g = pred[mask], gt[mask]
        p *= np.median(g) / np.median(p)
        accs.append(compute_errors_np(g, np.clip(p, 1e-3, 80)))
    if not accs:
        return {}
    return dict(zip(names, np.mean(accs, 0)))


class Trainer:
    """The training loop of one process on one device."""

    def __init__(self, cfg: Config, split_dir: Optional[str] = None,
                 device="cuda", profile_steps: int = 0):
        self.cfg = validate(cfg)
        self.device = check_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True  # fixed training shapes
        self.log_path = os.path.join(cfg.log_dir, cfg.model_name)
        self.models = build_models(cfg, self.device)

        # data
        dataset_cls = DATASETS[cfg.dataset]
        img_ext = ".png" if cfg.png else ".jpg"
        train_files = readlines(split_file(cfg.split, "train_files.txt",
                                           split_dir))
        val_files = readlines(split_file(cfg.split, "val_files.txt",
                                         split_dir))
        self.train_dataset = dataset_cls(
            cfg.data_path, train_files, cfg.height, cfg.width, cfg.frame_ids,
            is_train=True, img_ext=img_ext, load_pose=cfg.load_pose,
            seed=cfg.seed, native=cfg.native_loader, rt=cfg.robust_train)
        self.val_dataset = dataset_cls(
            cfg.data_path, val_files, cfg.height, cfg.width, cfg.frame_ids,
            is_train=False, img_ext=img_ext, load_pose=cfg.load_pose,
            seed=cfg.seed)
        self.train_loader = Loader(
            self.train_dataset, cfg.batch_size, shuffle=True, drop_last=True,
            num_workers=cfg.num_workers, seed=cfg.seed)
        self.val_loader = Loader(
            self.val_dataset, cfg.batch_size, shuffle=False,
            drop_last=False, num_workers=4, seed=cfg.seed)
        self.steps_per_epoch = max(1, len(self.train_loader))
        self.num_total_steps = self.steps_per_epoch * cfg.num_epochs

        self.optimizer, self.schedule = S.create_optimizer(
            self.models, cfg, self.steps_per_epoch)
        self.step = 0  # optimizer steps taken

        if cfg.weights_init == "pretrained":
            loaded = W.load_imagenet_encoders(cfg, self.models)
            if loaded:
                print(f"ImageNet init: {sorted(loaded)}", flush=True)
            else:
                print("WARNING: weights_init='pretrained' but no "
                      f"pretrain_resnet/resnet{cfg.res_arch}-*.pth found "
                      "(searched $PRETRAIN_RESNET_DIR, ./pretrain_resnet, "
                      "the checkout's root) -- keeping the scratch init",
                      flush=True)
        if cfg.load_weights_folder:
            self.load_weights(cfg.load_weights_folder)
        if cfg.mono_weights_folder:
            self.load_mono_weights(cfg.mono_weights_folder)

        self.logger = MetricsLogger(self.log_path, cfg.batch_size,
                                    self.num_total_steps)
        C.save_config(self.log_path, cfg)
        self.epoch = 0
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.seed + 1)
        self._val_iter = None
        # torch.profiler trace of steps [2, 2 + profile_steps)
        self.profile_steps = profile_steps
        self._profiler = None

    # ------------------------------------------------------------- loading

    def load_weights(self, folder: str):
        """Every model of ``cfg.models_to_load`` from a ``.pth`` folder;
        with its ``adam.pth`` also the optimizer and the step clock."""
        C.load_models(folder, self.models, self.cfg.models_to_load)
        step = C.load_optimizer(folder, self.optimizer, self.device)
        if step is not None:
            self.step = step
            S.set_schedule_step(self.optimizer, self.schedule, step)

    def load_mono_weights(self, folder: str):
        """Warm start of the mono and pose models, BatchNorm statistics
        included; the optimizer and the step stay fresh."""
        C.load_models(folder, self.models, MONO_MODELS)

    # ------------------------------------------------------------- running

    def _put(self, batch):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items() if k != "depth_gt"}

    def _log_cadence(self, batch_idx, step):
        early = (batch_idx % max(1, self.cfg.log_frequency) == 0
                 and step < 2000)
        return early or step % 2000 == 0

    def _profile_tick(self):
        if not self.profile_steps:
            return
        if self.step == 2 and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif self._profiler is not None and (
                self.step == 2 + self.profile_steps):
            self._stop_profiler()

    def _stop_profiler(self):
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = os.path.join(self.log_path, "profile")
        os.makedirs(out, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        self._profiler = None
        self.profile_steps = 0
        print(f"profile: {out}/trace.json", flush=True)

    def _host_losses(self, losses, outputs, batch):
        host = {k: float(v) for k, v in losses.items()}
        if "depth_gt" in batch:
            host.update(garg_depth_metrics(
                outputs["depth_mono"].float().cpu().numpy(),
                batch["depth_gt"]))
        return host

    def save(self, epoch=None, snapshot_step=None, last=False):
        return C.save_checkpoint(self.log_path, self.models, self.optimizer,
                                 self.schedule, self.step, self.cfg,
                                 epoch=epoch, snapshot_step=snapshot_step,
                                 last=last)

    def run_epoch(self):
        cfg = self.cfg
        use_z = self.epoch > cfg.ztrans_start_epc
        t_epoch = time.perf_counter()
        n = 0
        for batch_idx, batch in enumerate(self.train_loader.epoch(self.epoch)):
            t0 = time.time()
            self._profile_tick()
            device_batch = self._put(batch)
            draws = P.sample_draws(cfg, batch["color"].shape[0],
                                   self.generator, self.device)
            losses, outputs = S.train_step(self.models, self.optimizer,
                                           self.schedule, device_batch, cfg,
                                           use_z, draws)
            step = self.step
            self.step += 1
            n += 1
            if self._log_cadence(batch_idx, step):
                host = self._host_losses(losses, outputs, batch)
                self.logger.log_time(self.epoch, batch_idx, step,
                                     time.time() - t0, host["loss"])
                self.logger.log_scalars("train", host, step)
                self.logger.log_images("train", batch, outputs, step)
                self.validate(use_z, step)
            if cfg.save_intermediate_models and step % 2000 == 0:
                self.save(epoch=self.epoch, snapshot_step=step)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if n:
            ms = (time.perf_counter() - t_epoch) * 1e3 / n
            print(f"epoch {self.epoch}: {n} steps, {ms:.1f} ms/step wall "
                  "(data loading, logging and validation included)",
                  flush=True)

    @torch.no_grad()
    def validate(self, use_z, step):
        """One validation batch through ``forward_train`` with the models
        in eval mode, logged at ``step``."""
        if self._val_iter is None:
            self._val_iter = self.val_loader.epoch(self.epoch)
        try:
            batch = next(self._val_iter)
        except StopIteration:
            self._val_iter = self.val_loader.epoch(self.epoch)
            batch = next(self._val_iter)
        for m in self.models.values():
            m.eval()
        draws = P.sample_draws(self.cfg, batch["color"].shape[0],
                               self.generator, self.device)
        _, losses, outputs = P.forward_train(self.models, self._put(batch),
                                             self.cfg, use_z, draws)
        self.logger.log_scalars("val", self._host_losses(losses, outputs,
                                                         batch), step)
        self.logger.log_images("val", batch, outputs, step)

    def train(self):
        cfg = self.cfg
        # the resume epoch from the restored step (0 for a fresh run)
        start_epoch = min(self.step // self.steps_per_epoch, cfg.num_epochs)
        for self.epoch in range(start_epoch, cfg.num_epochs):
            self.run_epoch()
            if (self.epoch + 1) % cfg.save_frequency == 0:
                self.save(epoch=self.epoch)
        self.save(last=True)
        self._stop_profiler()
        self.logger.close()
