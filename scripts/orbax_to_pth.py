#!/usr/bin/env python3
"""Convert an Orbax checkpoint of the JAX trainer into a checkpoint folder
of the PyTorch port.

    python scripts/orbax_to_pth.py log/exp/models/weights_19 out_dir \\
        [--config log/exp/models/opt.json]

Runs where JAX and orbax are installed (the port itself imports neither).
The experiment's ``opt.json`` (``--config``, else the one the JAX trainer
writes beside its checkpoints, ``<orbax dir>/../opt.json``) gives the
models and ``param_dtype``. The JAX ``TrainState`` is restored against a
template of ``train/state.create_train_state`` and written through the
port's own ``train/checkpoints.save_checkpoint``, on the CPU:

- ``<model>.pth`` for every model of the state: parameters in
  ``param_dtype`` and BatchNorm statistics, under the reference's
  state_dict names (``weights.state_dict_from_jax``); ``mono_encoder.pth``
  also holds ``height`` and ``width``;
- ``adam.pth``: optax's Adam moments ``mu``/``nu`` of the ``main`` and
  ``mvs`` labels as ``exp_avg``/``exp_avg_sq`` of the port's two
  ``create_optimizer`` groups, each label's Adam ``count`` as every
  parameter's ``step``, and the state's step;
- a copy of ``opt.json``.

The port's ``cli.infer``, ``cli.evaluate`` and ``cli.train
--load_weights_folder <out dir>`` (a resume) load the folder as it is.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _adam_state(opt_state, label):
    """optax's ScaleByAdamState of one multi_transform label."""
    import optax

    inner = opt_state.inner_states[label]
    inner = getattr(inner, "inner_state", inner)  # MaskedState
    for part in inner:
        if isinstance(part, optax.ScaleByAdamState):
            return part
    raise ValueError(f"no Adam state under the optimizer label {label!r}")


def restore_state(orbax_dir: str, cfg_json: str):
    """The JAX TrainState of ``orbax_dir``, restored against the template
    that ``cfg_json`` (opt.json's text) defines."""
    import jax

    from movedepth_tpu.config import Config as JaxConfig
    from movedepth_tpu.models import build_models
    from movedepth_tpu.train.checkpoints import restore_checkpoint
    from movedepth_tpu.train.state import create_train_state

    jcfg = JaxConfig.from_json(cfg_json)
    models = build_models(jcfg)
    template = jax.eval_shape(lambda: create_train_state(
        models, jcfg, jax.random.PRNGKey(jcfg.seed))[0])
    return restore_checkpoint(orbax_dir, template)


def convert(orbax_dir: str, out_dir: str, config: str = None) -> str:
    """Write the port's checkpoint folder ``out_dir`` from the JAX
    trainer's Orbax checkpoint ``orbax_dir`` (see the module docstring);
    returns ``out_dir``."""
    import jax
    import numpy as np
    import torch

    from movedepth_tpu.train.state import MVS_GROUP
    from movedepth_tpu_torch.config import Config
    from movedepth_tpu_torch.models import build_models
    from movedepth_tpu_torch.train.checkpoints import save_checkpoint
    from movedepth_tpu_torch.train.state import create_optimizer
    from movedepth_tpu_torch.weights import state_dict_from_jax

    if config is None:
        config = os.path.join(orbax_dir, os.pardir, "opt.json")
    with open(config) as f:
        cfg_json = f.read()
    state = jax.device_get(restore_state(orbax_dir, cfg_json))
    cfg = Config.from_json(cfg_json)
    models = build_models(cfg, "cpu")
    if sorted(models) != sorted(state.params):
        raise ValueError(f"{config} builds the models {sorted(models)} but "
                         f"{orbax_dir} holds {sorted(state.params)}")
    for name, model in models.items():
        variables = {"params": state.params[name],
                     "batch_stats": state.batch_stats.get(name, {})}
        model.load_state_dict(state_dict_from_jax(name, variables,
                                                  cfg.scales))

    optimizer, schedule = create_optimizer(models, cfg)
    for label in ("main", "mvs"):
        adam = _adam_state(state.opt_state, label)
        count = torch.tensor(float(np.asarray(adam.count)),
                             dtype=torch.float32)
        for name, model in models.items():
            if (name in MVS_GROUP) != (label == "mvs"):
                continue
            mu = state_dict_from_jax(name, {"params": adam.mu[name]},
                                     cfg.scales)
            nu = state_dict_from_jax(name, {"params": adam.nu[name]},
                                     cfg.scales)
            for key, p in model.named_parameters():
                optimizer.state[p] = {"step": count.clone(),
                                      "exp_avg": mu[key],
                                      "exp_avg_sq": nu[key]}
    step = int(np.asarray(state.step))
    schedule.set_step(step)
    save_checkpoint(None, models, optimizer, schedule, step, cfg,
                    folder=out_dir)
    shutil.copyfile(config, os.path.join(out_dir, "opt.json"))
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Orbax checkpoint of the JAX trainer -> the PyTorch "
                    "port's .pth checkpoint folder")
    parser.add_argument("orbax_dir", help="an Orbax checkpoint, e.g. "
                        "log/exp/models/weights_19")
    parser.add_argument("out_dir", help="the folder to write")
    parser.add_argument("--config", default=None,
                        help="the experiment's opt.json (default: "
                             "<orbax_dir>/../opt.json)")
    args = parser.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = convert(args.orbax_dir, args.out_dir, args.config)
    names = sorted(f for f in os.listdir(out) if f.endswith(".pth"))
    print(f"wrote {out}: {', '.join(names)}, opt.json", flush=True)
    return out


if __name__ == "__main__":
    main()
