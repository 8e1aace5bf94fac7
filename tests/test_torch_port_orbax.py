"""``scripts/orbax_to_pth.py`` against the JAX trainer's own checkpoints.

A small JAX ``TrainState`` (64x96, ResNet18, 16 bins) takes one optax Adam
update on seeded gradients, so its moments are non-zero, gets perturbed
BatchNorm statistics and the pose head conditioned as
tests/test_torch_port_pipeline.py conditions it, and is written with the
JAX package's ``save_checkpoint`` and ``save_config``, for ``param_dtype``
float32 and bfloat16. The converter's folder must then

- load through the port's ``load_models``/``load_optimizer`` with every
  parameter, statistic, ``exp_avg``, ``exp_avg_sq`` and step equal bit for
  bit to the JAX state's mapped values, and take an Adam step;
- give the port's ``forward_infer`` (and ``cli.infer``) the JAX
  ``forward_infer`` of the restored state, within
  tests/test_torch_port_pipeline.py's gates;
- go back to the same JAX variables through the JAX package's
  ``train/torch_import.load_reference_checkpoint``.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from movedepth_tpu import pipeline as JP
from movedepth_tpu.models import build_models as jax_build_models
from movedepth_tpu.train import checkpoints as JC
from movedepth_tpu.train import state as JS
from movedepth_tpu.train import torch_import as TI
from movedepth_tpu.data.synthetic import make_batch
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.config import Config as PortConfig
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.train import checkpoints as C
from movedepth_tpu_torch.train.state import create_optimizer
from movedepth_tpu_torch.weights import state_dict_from_jax
from test_torch_port_pipeline import CFG, _close
from test_torch_port_trainer import kitti_tree, make_cfg  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import orbax_to_pth  # noqa: E402


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX models and their float32 initial variables, made once."""
    models = jax_build_models(CFG)
    return models, JS.init_variables(models, CFG, jax.random.PRNGKey(0))


def _jax_checkpoint(log, cfg):
    """The JAX trainer's files under ``log``: models/opt.json and the
    Orbax checkpoint models/weights_0 of a state one Adam step old, built
    as ``create_train_state`` builds it (parameters cast to
    ``param_dtype``, BatchNorm statistics float32)."""
    rng = np.random.default_rng(7)
    models, variables = _jax_init()
    params, stats = JS.split_variables(variables)
    dtype = jnp.dtype(cfg.param_dtype)
    params = jax.tree.map(lambda p: p.astype(dtype), params)
    tx = JS.create_optimizer(cfg, 1000, params)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1, p.shape), p.dtype), params)
    updates, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    params = jax.device_get(optax.apply_updates(params, updates))
    pose = params["pose"]["pose_2"]  # a few pixels of motion
    pose["kernel"] = (pose["kernel"] * 40).astype(pose["kernel"].dtype)
    stats = jax.tree.map(lambda s: np.asarray(
        rng.uniform(0.5, 1.5, s.shape), s.dtype), stats)
    state = JS.TrainState(step=jnp.ones((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=opt_state)
    JC.save_config(str(log), cfg)
    return JC.save_checkpoint(str(log), state, epoch=0), jax.device_get(
        state), models


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def converted(request, tmp_path_factory):
    cfg = CFG.replace(param_dtype=request.param)
    log = tmp_path_factory.mktemp(f"orbax_{request.param}")
    orbax_dir, state, jmodels = _jax_checkpoint(log, cfg)
    out = orbax_to_pth.main([orbax_dir, str(log / "pth")])
    return cfg, orbax_dir, state, jmodels, out


def _adam(state, label):
    return orbax_to_pth._adam_state(state.opt_state, label)


def test_converted_state_is_bit_for_bit(converted):
    cfg, _, state, _, out = converted
    pcfg = PortConfig.from_json(cfg.to_json())
    models = build_models(pcfg, "cpu")
    optimizer, _ = create_optimizer(models, pcfg)
    # the files' names and shapes against the port's own modules, not the
    # mapping that wrote them: every key present, none extra, a strict load
    fresh = build_models(pcfg, "cpu")
    for name, model in fresh.items():
        saved = torch.load(os.path.join(out, f"{name}.pth"),
                           weights_only=True)
        saved.pop("height", None), saved.pop("width", None)
        assert sorted(saved) == sorted(model.state_dict()), name
        model.load_state_dict(saved, strict=True)
    assert sorted(C.load_models(out, models, pcfg.models_to_load)) == sorted(
        state.params)
    assert C.load_optimizer(out, optimizer, "cpu") == int(state.step) == 1
    dtype = getattr(torch, cfg.param_dtype)
    for name, model in models.items():
        label = "mvs" if name in JS.MVS_GROUP else "main"
        want = state_dict_from_jax(name, {"params": state.params[name],
                                          "batch_stats":
                                          state.batch_stats.get(name, {})})
        got = model.state_dict()
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            assert torch.equal(got[k], want[k]), (name, k)
        mu = state_dict_from_jax(name, {"params": _adam(state, label).mu[name]})
        nu = state_dict_from_jax(name, {"params": _adam(state, label).nu[name]})
        count = float(_adam(state, label).count)
        for k, p in model.named_parameters():
            assert p.dtype == dtype, (name, k)
            st = optimizer.state[p]
            assert st["exp_avg"].dtype == dtype
            assert torch.equal(st["exp_avg"], mu[k]), (name, k)
            assert torch.equal(st["exp_avg_sq"], nu[k]), (name, k)
            assert float(st["step"]) == count == 1.0
            assert st["exp_avg"].abs().max() > 0
    enc = torch.load(os.path.join(out, "mono_encoder.pth"), weights_only=True)
    assert (enc["height"], enc["width"]) == (cfg.height, cfg.width)
    with open(os.path.join(out, "opt.json")) as f:
        assert PortConfig.from_json(f.read()) == pcfg
    # the resumed optimizer takes its next step from the loaded state
    for p in optimizer.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    optimizer.step()
    p = optimizer.param_groups[0]["params"][0]
    assert float(optimizer.state[p]["step"]) == 2.0


def test_forward_infer_matches_jax(converted, tmp_path):
    """The port's serving forward from the converted folder, as cli.infer
    loads it, against the JAX forward of the restored state. With bfloat16
    storage the JAX forward takes the restored values widened to float32
    (exact): its eval decoder sums folded kernel taps
    (``layers.fold_up2_kernel``, a TPU schedule) in the parameters' type,
    which rounds them, where the port convolves the stored weights as the
    reference does."""
    from movedepth_tpu_torch.cli.infer import load_models
    cfg, orbax_dir, _, jmodels, out = converted
    restored = orbax_to_pth.restore_state(orbax_dir, cfg.to_json())
    variables = JS.combine_variables(restored.params, restored.batch_stats)
    variables = jax.tree.map(lambda a: a.astype(jnp.float32), variables)
    batch = make_batch(cfg, 2, seed=11)
    want = jax.jit(lambda v, b: JP.forward_infer(jmodels, v, b, cfg))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    pcfg = PortConfig.from_json(cfg.to_json()).replace(load_weights_folder=out)
    models = load_models(pcfg, "cpu")
    got = P.forward_infer(models, P.as_batch(batch, "cpu"), pcfg)
    _close(got["disp_mono"], want["disp_mono"], atol=2e-5)
    _close(got["cost_prob"], want["cost_prob"], atol=1e-4)
    _close(got["disp_mvs"], want["disp_mvs"], atol=1e-4)


def test_round_trip_through_torch_import(converted, tmp_path):
    """JAX state -> .pth (the converter) -> JAX variables (the JAX
    package's reference-checkpoint loader): the same parameters and
    statistics. The JAX loader reads tensors through numpy, which has no
    bfloat16, so bfloat16 files are widened to float32 first (exact) and
    compared with the widened state."""
    cfg, _, state, _, out = converted
    folder = out
    if cfg.param_dtype == "bfloat16":
        folder = tmp_path / "f32"
        folder.mkdir()
        for f in os.listdir(out):
            if f.endswith(".pth") and f != C.OPTIMIZER_FILE:
                sd = torch.load(os.path.join(out, f), weights_only=True)
                torch.save({k: v.float() if isinstance(v, torch.Tensor)
                            and v.dtype == torch.bfloat16 else v
                            for k, v in sd.items()}, folder / f)
    back = TI.load_reference_checkpoint(str(folder), cfg)
    assert sorted(back) == sorted(state.params)
    for name, variables in back.items():
        want = {"params": state.params[name]}
        if state.batch_stats.get(name):
            want["batch_stats"] = state.batch_stats[name]
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
        got = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
        assert jax.tree.structure(got) == jax.tree.structure(want), name
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_trainer_resumes_from_the_converted_folder(converted, kitti_tree):
    """``cli.train --load_weights_folder`` on the converted folder: the
    trainer takes the JAX state's weights, Adam state and step, and
    trains on from there."""
    from movedepth_tpu_torch.train.trainer import Trainer
    cfg, _, state, _, out = converted
    root, splits = kitti_tree
    trainer = Trainer(make_cfg(root, load_weights_folder=out,
                               model_name=f"orbax_{cfg.param_dtype}",
                               num_depth_bins=cfg.num_depth_bins,
                               param_dtype=cfg.param_dtype, num_epochs=1),
                      split_dir=splits, device="cpu")
    assert trainer.step == int(state.step) == 1
    want = state_dict_from_jax("reg3d", {"params": state.params["reg3d"]})
    got = trainer.models["reg3d"].state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert len(trainer.optimizer.state) == sum(
        1 for m in trainer.models.values() for _ in m.parameters())
    trainer.train()
    assert trainer.step > 1
    for m in trainer.models.values():
        assert all(torch.isfinite(p).all() for p in m.parameters())


def test_refusal_names_the_converter(tmp_path):
    """An Orbax directory is recognised by its metadata files, and the
    refusal says how to convert it; a folder of neither kind is refused
    as before."""
    orbax = tmp_path / "weights_3"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(ValueError) as err:
        C.check_loadable(str(orbax))
    msg = str(err.value)
    assert "Orbax checkpoint" in msg
    assert f"python scripts/orbax_to_pth.py {orbax} <out dir>" in msg
    from movedepth_tpu_torch.cli import infer
    with pytest.raises(SystemExit, match="scripts/orbax_to_pth.py"):
        infer.load_models(PortConfig(load_weights_folder=str(orbax)), "cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="holds no .pth files"):
        C.check_loadable(str(empty))
