"""The system under test and its reference, built for one run from the
same seeded weights."""

from __future__ import annotations

import json

import torch

from mdbench import inputs
from mdbench.reference import models as RM


def program_config(run):
    """The program's ``Config`` of the run's configuration file."""
    from movedepth_tpu_torch.config import Config
    return Config.from_json(json.dumps(run.config))


def weights(run, mode):
    """The run's weights ({model: state dict} on the run's device), with
    the tensors scaled for ``mode`` ("infer" or "train") as the
    configuration file assumes."""
    scale = run.config_file["assumed"]["weight_scale"][mode]
    skeleton = RM.build(run.ref_cfg, "meta")
    return inputs.make_weights(skeleton, run.seed, run.device, scale)


def program_models(run, cfg, wts):
    """The program's models (``build_models``, eval mode) holding ``wts``."""
    from movedepth_tpu_torch.models import build_models
    models = build_models(cfg, run.device)
    inputs.load_weights(models, wts)
    return models


def reference_models(run, wts):
    """The reference's models on the run's device holding ``wts``."""
    models = RM.build(run.ref_cfg, run.device)
    inputs.load_weights(models, wts)
    return models


def free(*names, state):
    """Drop the program's objects from ``state`` and give their memory
    back, before the reference runs."""
    for name in names:
        setattr(state, name, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def flops(fn):
    """Convolution and matrix-product FLOPs of ``fn()`` as
    ``torch.utils.flop_counter`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())
