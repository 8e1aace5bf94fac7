"""Checkpoints of the port in the reference's layout.

``<log>/models/opt.json`` holds the config; each checkpoint is a folder
``models/weights_{epoch}``, ``models/weights_{epoch}_{step}`` (a per-step
snapshot) or ``models/last`` with one ``<model>.pth`` state_dict per model
(BatchNorm statistics included; the mono encoder's file also carries the
input ``height`` and ``width``, as the reference's does) and ``adam.pth``:
the optimizer's and the schedule's state and the step. Such a folder is a
reference ``.pth`` folder: ``weights.load_reference_folder`` reads it as it
is. An Orbax checkpoint of the JAX package needs JAX to read: where JAX
is installed, ``python scripts/orbax_to_pth.py <orbax dir> <out dir>``
converts it into such a folder, which then loads here unconverted.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch.weights import load_reference_folder

OPTIMIZER_FILE = "adam.pth"
# what an Orbax checkpoint directory holds beside its arrays
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA")


def checkpoint_dir(log_path: str, epoch: Optional[int] = None,
                   step: Optional[int] = None, last: bool = False) -> str:
    if last:
        name = "last"
    elif step is not None:
        name = f"weights_{epoch}_{step}"
    else:
        name = f"weights_{epoch}"
    return os.path.join(log_path, "models", name)


def save_config(log_path: str, cfg: Config) -> str:
    """``models/opt.json``: the experiment's config."""
    models_dir = os.path.join(log_path, "models")
    os.makedirs(models_dir, exist_ok=True)
    path = os.path.join(models_dir, "opt.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


def save_checkpoint(log_path: str, models: Mapping[str, torch.nn.Module],
                    optimizer, schedule, step: int, cfg: Config,
                    epoch: Optional[int] = None,
                    snapshot_step: Optional[int] = None,
                    last: bool = False, folder: Optional[str] = None) -> str:
    """Write every model's state_dict and ``adam.pth`` into a checkpoint
    folder (see the module docstring), or into ``folder`` when it is given;
    returns the folder."""
    path = folder or checkpoint_dir(log_path, epoch, snapshot_step, last)
    os.makedirs(path, exist_ok=True)
    for name, model in models.items():
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        if name == "mono_encoder":
            state.update(height=cfg.height, width=cfg.width)
        torch.save(state, os.path.join(path, f"{name}.pth"))
    torch.save({"optimizer": optimizer.state_dict(),
                "schedule": schedule.state_dict(), "step": int(step)},
               os.path.join(path, OPTIMIZER_FILE))
    return path


def check_loadable(folder: str):
    """Raise unless ``folder`` holds ``.pth`` files; for an Orbax
    checkpoint of the JAX package, say so and how to convert it."""
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"no checkpoint folder {folder}")
    names = os.listdir(folder)
    if any(f.endswith(".pth") for f in names):
        return
    if any(m in names for m in ORBAX_MARKERS):
        raise ValueError(
            f"{folder} is an Orbax checkpoint of the JAX package, which the "
            "PyTorch port does not read: convert it where JAX is installed, "
            f"with `python scripts/orbax_to_pth.py {folder} <out dir>` (it "
            "reads opt.json beside the checkpoint, or --config), and load "
            "<out dir> instead")
    raise ValueError(f"{folder} holds no .pth files: it is not a reference "
                     ".pth folder or a checkpoint of the port")


def load_models(folder: str, models: Mapping[str, torch.nn.Module],
                names) -> list:
    """Load ``<folder>/<name>.pth`` into each of ``models`` named in
    ``names`` (BatchNorm statistics included); returns the names loaded."""
    check_loadable(folder)
    return load_reference_folder(folder, {n: models[n] for n in names
                                          if n in models})


def load_optimizer(folder: str, optimizer, device) -> Optional[int]:
    """Restore the optimizer's state from ``<folder>/adam.pth`` and return
    the step it was saved at; None when the folder has no such file or
    the reference's (the optimizer's state_dict alone, with no step: its
    parameter groups are not the port's), as for a folder of weights
    alone.

    The saved groups' hyperparameters replace the live ones, ``capturable``
    included, which says where Adam keeps its step counts: a file written
    on the CPU (or before Adam was capturable) has it False, one written
    on the card True. Each group keeps the live optimizer's value, and the
    step counts move where it puts them (capturable: float32 on the
    parameter's device; else on the host). The moments load in their
    parameter's type (torch's rule), so bfloat16 ones stay bfloat16."""
    path = os.path.join(folder, OPTIMIZER_FILE)
    if not os.path.isfile(path):
        return None
    saved = torch.load(path, map_location=device, weights_only=True)
    if "step" not in saved:
        return None
    capturable = [g["capturable"] for g in optimizer.param_groups]
    optimizer.load_state_dict(saved["optimizer"])
    for group, live in zip(optimizer.param_groups, capturable):
        group["capturable"] = live
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(
                    p.device if live else "cpu", torch.float32)
    return int(saved["step"])
