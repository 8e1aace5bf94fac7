"""Training orchestrator of the port: epoch loop, validation, logging and
checkpoints (port of movedepth_tpu/train/trainer.py).

Each process trains on one device: ``cuda`` unless the caller asks for
``cpu``. Data-parallel training runs one such process per card under a
process group (``parallel/dist.py``, started by ``cli/train`` under
torchrun): each rank reads its rank-strided shard of the train and val
lists at ``cfg.batch_size`` rows, its BatchNorms and masked means see the
global batch, and its gradients are averaged over the ranks before Adam,
so that the ranks take the steps of one process at the global batch.
Every rank stops its epoch at the fewest steps any rank's shard gives.
Rank 0 alone logs and writes checkpoints; every rank restores.

Randomness comes from two explicit ``torch.Generator``s: the weights from
one seeded with ``cfg.seed`` (``build_models``), the masked-augmentation
boxes and automask noise of every train and validation forward from one on
the device seeded with ``cfg.seed + 1`` (``pipeline.sample_draws``; every
rank draws the global batch's and keeps its rows). The data loader draws
its own augmentation from (seed, epoch, index), as the JAX package's does,
and reads the images with the C++ loader unless ``native_loader`` is off
(the trainer says which at start-up).

Checkpoints are reference ``.pth`` folders plus ``adam.pth``
(train/checkpoints.py), saved every ``save_frequency`` epochs and always as
``last``. Resuming from a folder with ``adam.pth`` continues the step
clock: the epoch, the z-guided bins and the learning-rate schedule go on
where the saved run left off. A reference folder without it starts at step
0.

With ``steps_per_dispatch`` K > 1 an epoch runs in groups of K batches
through ``train.state.make_train_multistep`` (on the card, replays of a
CUDA graph of one step; a gloo group on the card raises), with the step
and batch accounting of the single-step loop; the tail of fewer than K
batches runs as single steps.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch import trace
from movedepth_tpu_torch import weights as W
from movedepth_tpu_torch.config import Config, validate
from movedepth_tpu_torch.data.kitti import (KITTIDepthDataset,
                                            KITTIOdomDataset,
                                            KITTIRawDataset, readlines)
from movedepth_tpu_torch.data.loader import Loader, ShardedIndexSampler
from movedepth_tpu_torch.data.splits import split_file
from movedepth_tpu_torch.eval.evaluate import (check_device,
                                                compute_errors_np,
                                                resize_depth)
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.parallel import dist as D
from movedepth_tpu_torch.parallel.sync_bn import convert_sync_batchnorm
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


GARG_NAMES = ("de/abs_rel", "de/sq_rel", "de/rms", "de/log_rms", "da/a1",
              "da/a2", "da/a3")


def garg_depth_metrics(depth_pred: np.ndarray, depth_gt: np.ndarray,
                       group=None) -> Dict:
    """During-training GT metrics with the Garg crop at 375x1242, median
    scaled: abs_rel, sq_rel, rms, log_rms and the three accuracies, the
    mean over the samples with GT in the crop (over every rank's samples
    with a process ``group``); {} when there is none."""
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
    if group is not None:
        sums = D.all_reduce_host(
            [*np.sum(accs, 0).reshape(-1), len(accs)] if accs
            else [0.0] * (len(GARG_NAMES) + 1), group)
        count = sums.pop()
        return dict(zip(GARG_NAMES, np.divide(sums, count))) if count else {}
    if not accs:
        return {}
    return dict(zip(GARG_NAMES, np.mean(accs, 0)))


def per_call(summ: dict) -> dict:
    """A tracer summary as ``spans.json`` holds it: per span its calls,
    host ms mean and max, self host ms (total), device ms mean (None
    without events) and parents; every counter."""
    spans = {}
    for name, s in summ["spans"].items():
        spans[name] = {
            "calls": s["calls"],
            "host_ms_mean": s["host_ms"] / s["calls"],
            "host_ms_max": s["host_max_ms"],
            "self_host_ms": s["self_host_ms"],
            "device_ms_mean": (s["device_ms"] / s["device_calls"]
                               if s["device_calls"] else None),
            "parents": s["parents"],
        }
    return {"spans": spans, "counters": dict(summ["counters"])}


class Trainer:
    """The training loop of one process on one device; with a process
    ``group``, of rank ``rank`` of ``world_size`` data-parallel ranks."""

    def __init__(self, cfg: Config, split_dir: Optional[str] = None,
                 device="cuda", profile_steps: int = 0, rank: int = 0,
                 world_size: int = 1, group=None):
        self.cfg = validate(cfg)
        self.device = check_device(device)
        if world_size > 1 and group is None:
            raise ValueError(f"world_size {world_size} needs a process group")
        self.rank, self.world_size, self.group = rank, world_size, group
        if self.device.type == "cuda":
            # fixed training shapes: cuDNN times its algorithms, but not
            # for a rematerialized step. Its timed choices are cached per
            # thread, and the recompute runs on autograd's device thread,
            # which may time another algorithm than the forward took: the
            # backward would then differ from the step it recomputes
            torch.backends.cudnn.benchmark = not P.remat_gate(
                cfg.batch_size, self.cfg)[0]
        self.log_path = os.path.join(cfg.log_dir, cfg.model_name)
        self.models = build_models(cfg, self.device)
        if group is not None:
            convert_sync_batchnorm(self.models, group)

        # data
        dataset_cls = DATASETS[cfg.dataset]
        img_ext = ".png" if cfg.png else ".jpg"
        train_files = readlines(split_file(cfg.split, "train_files.txt",
                                           split_dir))
        val_list = split_file(cfg.split, "val_files.txt", split_dir)
        val_files = readlines(val_list)
        if len(val_files) < world_size:  # rank r reads lines r, r + world..
            raise ValueError(
                f"rank {len(val_files)} of {world_size} gets no validation "
                f"line: {val_list} has {len(val_files)}")
        self.train_dataset = dataset_cls(
            cfg.data_path, train_files, cfg.height, cfg.width, cfg.frame_ids,
            is_train=True, img_ext=img_ext, load_pose=cfg.load_pose,
            seed=cfg.seed, native=cfg.native_loader, rt=cfg.robust_train)
        self.val_dataset = dataset_cls(
            cfg.data_path, val_files, cfg.height, cfg.width, cfg.frame_ids,
            is_train=False, img_ext=img_ext, load_pose=cfg.load_pose,
            seed=cfg.seed, native=cfg.native_loader)
        if rank == 0:
            print(self._startup_line(), flush=True)
        self.train_loader = Loader(
            self.train_dataset, cfg.batch_size, rank, world_size,
            shuffle=True, drop_last=True, num_workers=cfg.num_workers,
            seed=cfg.seed)
        self.val_loader = Loader(
            self.val_dataset, cfg.batch_size, rank, world_size,
            shuffle=False, drop_last=False, num_workers=4, seed=cfg.seed)
        # every rank stops at the fewest steps of any rank, the last
        # rank's: a rank with one step more would wait in a collective
        # forever
        self.steps_per_epoch = max(1, len(ShardedIndexSampler(
            len(self.train_dataset), cfg.batch_size, world_size - 1,
            world_size)))
        self.num_total_steps = self.steps_per_epoch * cfg.num_epochs

        self.optimizer, self.schedule = S.create_optimizer(
            self.models, cfg, self.steps_per_epoch)
        self.train_multistep = (
            S.make_train_multistep(self.models, self.optimizer,
                                   self.schedule, cfg, group)
            if cfg.steps_per_dispatch > 1 else None)
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
        D.broadcast_models(self.models, group)

        self.logger = MetricsLogger(self.log_path, rank,
                                    cfg.batch_size * world_size,
                                    self.num_total_steps)
        if rank == 0:
            C.save_config(self.log_path, cfg)
        self.epoch = 0
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.seed + 1)
        self._val_iter = None
        # (time, steps taken) after the last log: the terminal line's rate
        self._rate_mark = None
        self._seconds_per_step = None
        # torch.profiler trace and the tracer's spans of rank 0's steps
        # [2, 2 + profile_steps)
        self.profile_steps = profile_steps if rank == 0 else 0
        self._profiler = None
        self._counters_before = {}

    def _startup_line(self) -> str:
        """What reads each dataset (robust_train's offsets included), the
        parameters' storage type, the rematerialization at the configured
        batch and, on the card, whether cuDNN times its algorithms."""
        cfg = self.cfg
        native = self.train_dataset.native
        rt = (" (train with robust_train's frame offsets)"
              if cfg.robust_train else "")
        if native is None:
            data = ("data: PIL loader (--no-native_loader) for train and "
                    f"val{rt}")
        else:
            built = ("already built" if native.build_s is None
                     else f"built in {native.build_s:.1f} s")
            data = (f"data: {native.describe()}; csrc/loader.cpp {built}; "
                    f"it reads train and val{rt}")
        heavy, heavy_enc = P.remat_gate(cfg.batch_size, cfg)
        remat = (f"remat {'on' if heavy else 'off'} at batch "
                 f"{cfg.batch_size} (remat_batch_threshold "
                 f"{cfg.remat_batch_threshold}: heavy={heavy}, "
                 f"heavy_enc={heavy_enc}, remat_scope {cfg.remat_scope})")
        if self.device.type == "cuda":
            remat += (f"; cuDNN autotuning "
                      f"{'off' if heavy else 'on'}")
        params = (f"parameters {cfg.param_dtype}" if cfg.param_dtype ==
                  "float32" else f"parameters {cfg.param_dtype} (BatchNorm "
                  "statistics float32)")
        return f"{data}\n{params}; {remat}"

    # ------------------------------------------------------------- loading

    def load_weights(self, folder: str):
        """Every model of ``cfg.models_to_load`` from a ``.pth`` folder;
        with its ``adam.pth`` also the optimizer and the step clock."""
        C.load_models(folder, self.models, self.cfg.models_to_load)
        step = C.load_optimizer(folder, self.optimizer, self.device)
        if step is not None:
            self.step = step
            self.schedule.set_step(step)

    def load_mono_weights(self, folder: str):
        """Warm start of the mono and pose models, BatchNorm statistics
        included; the optimizer and the step stay fresh."""
        C.load_models(folder, self.models, MONO_MODELS)

    # ------------------------------------------------------------- running

    @trace.traced("trainer.put")
    def _put(self, batch):
        host = {k: torch.from_numpy(v) for k, v in batch.items()
                if k != "depth_gt"}
        P.count_h2d(host.values())
        return {k: v.to(self.device) for k, v in host.items()}

    def _draws(self, rows):
        """This rank's draws for a batch of ``rows`` rows. Ranks draw for
        ``cfg.batch_size`` rows each, which every train batch has, so
        their generators stay alike when a rank's last val batch is
        shorter."""
        if self.group is None:
            return P.sample_draws(self.cfg, rows, self.generator,
                                  self.device)
        draws = P.sample_draws(self.cfg, self.cfg.batch_size, self.generator,
                               self.device, self.rank, self.world_size)
        return dict(draws, noise=[n[:rows] for n in draws["noise"]])

    def _log_cadence(self, batch_idx, step):
        early = (batch_idx % max(1, self.cfg.log_frequency
                                 // self.world_size) == 0 and step < 2000)
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
            self._counters_before = trace.counters()
            trace.enable()
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
        self._write_spans(os.path.join(out, "spans.json"))

    def _write_spans(self, path):
        """The tracer's spans of the profiled steps and the counters' growth
        over them, as ``spans.json``; prints the ten spans with the most
        self time."""
        summ = trace.summary()
        trace.disable()
        before = self._counters_before
        summ["counters"] = {k: n - before.get(k, 0)
                            for k, n in summ["counters"].items()}
        table = per_call(summ)
        with open(path, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        top = sorted(table["spans"].items(),
                     key=lambda kv: -kv[1]["self_host_ms"])[:10]
        print(f"spans: {path}; most self time (host ms, calls):", flush=True)
        for name, s in top:
            print(f"  {name}: {s['self_host_ms']:.1f} ({s['calls']})",
                  flush=True)

    def _host_losses(self, losses, outputs, batch):
        """The losses and Garg metrics as floats, means over the ranks."""
        host = D.reduce_mean_scalars({k: float(v) for k, v in losses.items()},
                                     self.group)
        if "depth_gt" in batch:
            host.update(garg_depth_metrics(
                outputs["depth_mono"].float().cpu().numpy(),
                batch["depth_gt"], self.group))
        return host

    def save(self, epoch=None, snapshot_step=None, last=False):
        """Rank 0 writes the checkpoint folder; every rank waits for it.
        Returns the folder."""
        path = C.checkpoint_dir(self.log_path, epoch, snapshot_step, last)
        if self.rank == 0:
            C.save_checkpoint(self.log_path, self.models, self.optimizer,
                              self.schedule, self.step, self.cfg,
                              epoch=epoch, snapshot_step=snapshot_step,
                              last=last)
        D.barrier(self.group)
        return path

    def _log_step(self, batch, losses, outputs, batch_idx, step, use_z):
        """Log ``step``: its losses (the read waits for the device), the
        terminal line, images and one validation batch. The line's rate
        is the steps taken since the last log over the wall time from the
        end of that log to this read."""
        with trace.span("trainer.log"):
            host = self._host_losses(losses, outputs, batch)
            t_mark, s_mark = self._rate_mark
            if self.step > s_mark:
                self._seconds_per_step = ((time.perf_counter() - t_mark)
                                          / (self.step - s_mark))
            self.logger.log_time(self.epoch, batch_idx, step,
                                 self._seconds_per_step, host["loss"])
            self.logger.log_scalars("train", host, step)
            self.logger.log_images("train", batch, outputs, step)
            self.validate(use_z, step)
        self._rate_mark = (time.perf_counter(), self.step)

    def _single_step(self, batch, batch_idx, use_z):
        """One train_step on a host batch, then its logging and snapshot."""
        cfg = self.cfg
        self._profile_tick()
        device_batch = self._put(batch)
        draws = self._draws(batch["color"].shape[0])
        losses, outputs = S.train_step(
            self.models, self.optimizer, self.schedule, device_batch, cfg,
            use_z, draws, self.group)
        step = self.step
        self.step += 1
        if self._log_cadence(batch_idx, step):
            self._log_step(batch, losses, outputs, batch_idx, step, use_z)
        if cfg.save_intermediate_models and step % 2000 == 0:
            self.save(epoch=self.epoch, snapshot_step=step)

    def _dispatch(self, group, batch_idx, use_z):
        """K = len(group) steps in one call of the multi-step dispatch.
        The losses are read at the log events after it; there the image
        outputs and Garg metrics come from a no-grad ``forward_train`` of
        the models in eval mode on one more draw (the dispatch does not
        materialize them), and a ``save_intermediate_models`` snapshot
        holds the end-of-group state, up to K-1 steps past its label, as
        in the JAX package."""
        cfg = self.cfg
        k = len(group)
        device_batches = [self._put(b) for b in group]
        draws = [self._draws(b["color"].shape[0]) for b in group]
        losses = self.train_multistep(device_batches, draws, use_z)
        start = self.step
        self.step += k
        for s in range(k):
            step = start + s
            if self._log_cadence(batch_idx + s, step):
                outputs = self._train_outputs(device_batches[s], use_z)
                self._log_step(group[s],
                               {key: v[s] for key, v in losses.items()},
                               outputs, batch_idx + s, step, use_z)
            if cfg.save_intermediate_models and step % 2000 == 0:
                self.save(epoch=self.epoch, snapshot_step=step)

    @torch.no_grad()
    def _train_outputs(self, device_batch, use_z):
        for m in self.models.values():
            m.eval()
        _, _, outputs = P.forward_train(
            self.models, device_batch, self.cfg, use_z,
            self._draws(device_batch["color"].shape[0]), self.group)
        return outputs

    def run_epoch(self):
        """One epoch: single train_steps, or with ``steps_per_dispatch`` K
        > 1 groups of K batches through the multi-step dispatch and a tail
        of single steps (``profile_steps`` traces single steps only)."""
        cfg = self.cfg
        use_z = self.epoch > cfg.ztrans_start_epc
        k = cfg.steps_per_dispatch
        t_epoch = time.perf_counter()
        self._rate_mark = (t_epoch, self.step)
        n = 0
        batches = self.train_loader.epoch(self.epoch)
        it = self._fetch(batches)
        try:
            while True:
                group = list(itertools.islice(it, k))
                if not group:
                    break
                if len(group) == k > 1:
                    self._dispatch(group, n, use_z)
                else:  # k = 1, or the tail of fewer than k batches
                    for i, batch in enumerate(group):
                        self._single_step(batch, n + i, use_z)
                if n == 0:
                    t_first, n_first = time.perf_counter(), len(group)
                n += len(group)
        finally:
            batches.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if n and self.rank == 0:
            t_end = time.perf_counter()
            ms = (t_end - t_epoch) * 1e3 / n
            # a process's first step also autotunes cuDNN (the first
            # dispatch, and captures its graph)
            warm = (f", {(t_end - t_first) * 1e3 / (n - n_first):.1f} "
                    f"after the first{f' {n_first}' if n_first > 1 else ''}"
                    if n > n_first else "")
            print(f"epoch {self.epoch}: {n} steps, {ms:.1f} ms/step wall"
                  f"{warm} (data loading, logging and validation included)",
                  flush=True)

    def _fetch(self, batches):
        """The epoch's first ``steps_per_epoch`` batches, each wait for the
        loader the span ``trainer.data_wait``."""
        for _ in range(self.steps_per_epoch):
            with trace.span("trainer.data_wait"):
                batch = next(batches, None)
            if batch is None:
                return
            yield batch

    @torch.no_grad()
    @trace.traced("trainer.validate")
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
        draws = self._draws(batch["color"].shape[0])
        _, losses, outputs = P.forward_train(self.models, self._put(batch),
                                             self.cfg, use_z, draws,
                                             self.group)
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
