"""Optimizer, learning-rate schedule and the train step (port of
movedepth_tpu/train/state.py).

Adam with two learning-rate groups: the MVS group (mask_cnn, mvs_encoder,
reg3d) runs at ``learning_rate * lr_fac``, the rest at ``learning_rate``.
The rate drops x0.1 every ``scheduler_step_size`` epochs before
``num_epochs``, counted in optimizer steps, as the JAX package's optax
piecewise-constant schedule does. The XLA-only levers of the JAX package
(compiler options, scoped-VMEM limits, the multi-step scan) have no
counterpart, nor has rematerialization yet.
"""

from __future__ import annotations

import bisect
from typing import Dict

import torch

from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch.pipeline import forward_train

# the models updated at learning_rate * lr_fac (the JAX package's MVS_GROUP)
MVS_GROUP = ("mask_cnn", "mvs_encoder", "reg3d")


def lr_milestones(cfg: Config, steps_per_epoch: int):
    """Optimizer steps at which the learning rate drops x0.1."""
    step = cfg.scheduler_step_size
    return [e * steps_per_epoch for e in range(step, cfg.num_epochs, step)]


def create_optimizer(models: Dict[str, torch.nn.Module], cfg: Config,
                     steps_per_epoch: int = 1000):
    """(Adam over every model's parameters in the two groups, its
    step-based schedule). Call the schedule's ``step()`` after each
    optimizer step."""
    groups = [
        {"params": [p for name in sorted(models) if name not in MVS_GROUP
                    for p in models[name].parameters()],
         "lr": cfg.learning_rate},
        {"params": [p for name in sorted(models) if name in MVS_GROUP
                    for p in models[name].parameters()],
         "lr": cfg.learning_rate * cfg.lr_fac},
    ]
    optimizer = torch.optim.Adam(groups, lr=cfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    schedule = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, lr_milestones(cfg, steps_per_epoch), gamma=0.1)
    return optimizer, schedule


def set_schedule_step(optimizer, schedule, step: int):
    """Put the schedule (and each group's rate) at optimizer step ``step``
    under its own milestones, as a run that took ``step`` steps has it."""
    schedule.last_epoch = step
    milestones = sorted(schedule.milestones.elements())
    for group, base in zip(optimizer.param_groups, schedule.base_lrs):
        group["lr"] = base * schedule.gamma ** bisect.bisect_right(milestones,
                                                                   step)
    schedule._last_lr = [g["lr"] for g in optimizer.param_groups]


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def train_step(models, optimizer, schedule, batch, cfg: Config,
               use_z_bins: bool, draws):
    """One optimizer step: the models in train mode, ``forward_train``,
    ``backward()``, Adam, the schedule. The gradients of this step stay in
    each parameter's ``.grad`` until the next step. Returns (the losses
    dict, the outputs dict), detached."""
    if cfg.steps_per_dispatch > 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 (the JAX package's multi-step scan) is "
            "not ported yet (ROADMAP Queue 1 item 13b)")
    for m in models.values():
        m.train()
    optimizer.zero_grad(set_to_none=True)
    total, losses, outputs = forward_train(models, batch, cfg, use_z_bins,
                                           draws)
    total.backward()
    optimizer.step()
    schedule.step()
    return _detached(losses), _detached(outputs)
