"""The port's train steps against the JAX package's multi-step dispatch
(``steps_per_dispatch``) on the CPU.

The port has no multi-step dispatch: every step is one
``train.state.train_step``. Two sequential port steps are held to the JAX
package's scanned K = 2 steps from the same weights, batches and injected
draws: step 1's losses under the train-step parity tolerances of
tests/test_torch_port_train.py, step 2's total loss and the parameters
after both under the loose tier of
tests/test_pipeline.py::test_multistep_matches_sequential (the loss at
rtol 5e-3, the parameters at rtol 5e-2 / atol 1e-3, the bounds of the
chaotic amplification that test describes). Then what makes the step
capturable on the card, checked where it runs here: the
masked-augmentation box as two device tensors (the mask bit for bit the
sliced one at every position), Adam with tensor rates written in place by
the schedule (the updates and rates of a float-rate Adam under
MultiStepLR across two milestones and after the resume's ``set_step``),
and a trainer epoch with ``steps_per_dispatch=2``, which takes one step a
batch. 64x96, 8 bins, float32.
"""

import copy
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movedepth_tpu.data.synthetic import make_batch
from movedepth_tpu.models import build_models as jax_build_models
from movedepth_tpu.train import state as JS
from movedepth_tpu.train import torch_import as TI
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.ops import masking as M
from movedepth_tpu_torch.train import state as S
from movedepth_tpu_torch.train.trainer import Trainer
from movedepth_tpu_torch.weights import state_dict_from_jax
from test_torch_port_pipeline import B, CFG, H, W, _state_dicts
from test_torch_port_trainer import kitti_tree, make_cfg  # noqa: F401

MCFG = CFG.replace(num_depth_bins=8)
KEYS = (11, 12)  # each step's rng key, as the JAX test's
LOOSE = ("loss/", "mono_loss", "loss")  # test_torch_port_train's 1e-3 keys


def _draws(seed):
    """forward_train's draws from PRNGKey(seed), as
    tests/test_torch_port_train.py derives them: split 1 -> the box, split
    2 -> the photometric key, then one split per mono scale."""
    rng, sub_mask = jax.random.split(jax.random.PRNGKey(seed))
    kx, ky = jax.random.split(sub_mask)
    fh, fw = H // 3, W // 3
    box = (int(jax.random.randint(kx, (), 0, W - fw)),
           int(jax.random.randint(ky, (), 0, H - fh)))
    _, r = jax.random.split(rng)
    noise = []
    for _ in MCFG.scales:
        r, s = jax.random.split(r)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(s, (B, H, W, 1)))))
    return {"box": box, "noise": noise}


@pytest.fixture(scope="module")
def setup():
    states = _state_dicts(MCFG)
    batches = [make_batch(MCFG, B, seed=s) for s in (1, 2)]
    return states, batches


@pytest.fixture(scope="module")
def jax_side(setup):
    """The JAX package's scanned K = 2 steps: (losses (2,) each, the
    parameters after both)."""
    states, batches = setup
    variables = {name: TI.convert_state_dict(
        name, {k: v.numpy() for k, v in sd.items()})
        for name, sd in states.items()}
    params, stats = JS.split_variables(variables)
    tx = JS.create_optimizer(MCFG, 1000, params)
    state = JS.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=tx.init(params))
    multi = JS.make_train_multistep(jax_build_models(MCFG), MCFG, tx)
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *batches)
    rngs = jnp.stack([jax.random.PRNGKey(k) for k in KEYS])
    new_state, losses = multi(state, stacked, rngs, jnp.asarray(True))
    return ({k: np.asarray(v) for k, v in losses.items()},
            jax.tree.map(np.asarray, new_state.params))


@pytest.fixture(scope="module")
def port_side(setup):
    """The port's first two steps, sequential train_step calls on one torch
    thread: (losses {key: (2,)}, models)."""
    states, batches = setup
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        models = build_models(MCFG, "cpu")
        for name, m in models.items():
            m.load_state_dict(states[name])
        opt, sched = S.create_optimizer(models, MCFG)
        steps = [S.train_step(models, opt, sched, P.as_batch(b, "cpu"),
                              MCFG, True, _draws(seed))[0]
                 for b, seed in zip(batches, KEYS)]
    finally:
        torch.set_num_threads(threads)
    assert sched.last_epoch == 2
    return {key: torch.stack([s[key] for s in steps]) for key in steps[0]}, \
        models


def test_multistep_matches_jax_multistep(jax_side, port_side):
    want_losses, want_params = jax_side
    losses, models = port_side
    assert sorted(losses) == sorted(want_losses)
    for key, want in want_losses.items():
        assert want.shape == losses[key].shape == (2,)
        rtol = 1e-3 if key.startswith(LOOSE) else 2e-4
        np.testing.assert_allclose(float(losses[key][0]), want[0], rtol=rtol,
                                   atol=2e-6, err_msg=key)
    # step 2, as the JAX test takes it: the total loss alone (the masked
    # loss compares two nearly equal depth maps and moves by ~2% with a
    # step-1 update that differs in its last digits)
    np.testing.assert_allclose(float(losses["loss"][1]),
                               want_losses["loss"][1], rtol=5e-3)
    for name, model in models.items():
        want = state_dict_from_jax(name, {"params": want_params[name]},
                                   MCFG.scales)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=5e-2, atol=1e-3,
                                       err_msg=f"{name}.{k}")


@pytest.mark.parametrize("as_tensors", [False, True])
def test_box_mask_equals_sliced_mask_everywhere(as_tensors):
    """Every box position of a 64x96 frame (21x32 boxes): the mask built by
    comparing pixel indices with the box equals the one made by slicing,
    bit for bit, with the box as ints or as 0-d tensors."""
    img = torch.rand(1, H, W, 3, generator=torch.Generator().manual_seed(0))
    fh, fw = H // 3, W // 3
    for y0 in range(H - fh):
        for x0 in range(W - fw):
            box = ((torch.tensor(x0), torch.tensor(y0)) if as_tensors
                   else (x0, y0))
            got_img, got = M.random_image_mask(img, (fh, fw), box)
            want = torch.ones(H, W)
            want[y0:y0 + fh, x0:x0 + fw] = 0.0
            assert torch.equal(got, want[None, :, :, None].expand(img.shape))
            assert torch.equal(got_img, img * got)


def test_sample_draws_box_is_two_device_tensors():
    draws = P.sample_draws(MCFG, 2, torch.Generator().manual_seed(3), "cpu")
    x0, y0 = draws["box"]
    assert x0.shape == y0.shape == () and x0.dtype == torch.int64
    assert 0 <= int(x0) < W - W // 3 and 0 <= int(y0) < H - H // 3


def test_tensor_rates_match_float_schedule():
    """The port's Adam (a float32 rate tensor a group, which the schedule
    overwrites in place) against torch's Adam with float rates under
    MultiStepLR: the same rates at every step across two milestones, the
    same parameters after each step, and the same rates after
    ``set_step`` (a resume), also once a loaded state has put other rate
    objects in the groups."""
    cfg = MCFG.replace(num_epochs=6, scheduler_step_size=2, lr_fac=0.5)
    gen = torch.Generator().manual_seed(0)
    models = {"mono_encoder": torch.nn.Linear(5, 3),
              "reg3d": torch.nn.Linear(5, 3)}
    ref = copy.deepcopy(models)
    opt, sched = S.create_optimizer(models, cfg, steps_per_epoch=3)
    lrs = [g["lr"] for g in opt.param_groups]
    ref_opt = torch.optim.Adam(
        [{"params": list(ref["mono_encoder"].parameters()),
          "lr": cfg.learning_rate},
         {"params": list(ref["reg3d"].parameters()),
          "lr": cfg.learning_rate * cfg.lr_fac}], betas=(0.9, 0.999),
        eps=1e-8)
    ref_sched = torch.optim.lr_scheduler.MultiStepLR(
        ref_opt, S.lr_milestones(cfg, 3), gamma=0.1)
    assert sched.milestones == [6, 12]
    for _ in range(14):
        x = torch.randn(4, 5, generator=gen)
        for ms, o in ((models, opt), (ref, ref_opt)):
            o.zero_grad()
            sum(m(x).square().sum() for m in ms.values()).backward()
            o.step()
        sched.step()
        ref_sched.step()
        assert all(g["lr"] is lr for g, lr in zip(opt.param_groups, lrs))
        np.testing.assert_allclose([float(lr) for lr in lrs],
                                   ref_sched.get_last_lr(), rtol=1e-6)
        assert sched.rates(sched.last_epoch) == pytest.approx(
            ref_sched.get_last_lr(), rel=1e-12)
        for a, b in zip(models.values(), ref.values()):
            for p, q in zip(a.parameters(), b.parameters()):
                np.testing.assert_allclose(p.detach().numpy(),
                                           q.detach().numpy(), rtol=1e-6,
                                           atol=1e-9)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    assert all(g["lr"] is not lr for g, lr in zip(opt.param_groups, lrs))
    for step, drops in ((0, 0), (7, 1), (12, 2), (5, 0)):
        sched.set_step(step)
        assert sched.last_epoch == step
        assert all(g["lr"] is lr for g, lr in zip(opt.param_groups, lrs))
        np.testing.assert_allclose(
            [float(lr) for lr in lrs],
            [cfg.learning_rate * 0.1 ** drops,
             cfg.learning_rate * cfg.lr_fac * 0.1 ** drops], rtol=1e-6)


@pytest.mark.parametrize("written", ["on_the_card", "with_float_rates"])
def test_optimizer_resume_keeps_the_live_capturable(written, tmp_path):
    """An ``adam.pth`` written on the card (its groups ``capturable``) or by
    an Adam with float rates resumes on the CPU: each group keeps the live
    optimizer's ``capturable`` (False here) and the schedule's rate tensor,
    the step counts stay on the host, and the three steps after the resume
    equal those after resuming from this device's own file."""
    from movedepth_tpu_torch.train import checkpoints as C
    cfg = MCFG.replace(num_epochs=4, scheduler_step_size=2)
    torch.manual_seed(0)
    models = {"mono_encoder": torch.nn.Linear(5, 3),
              "reg3d": torch.nn.Linear(5, 3)}

    def steps(models, opt, sched, n):
        gen = torch.Generator().manual_seed(1)
        for _ in range(n):
            x = torch.randn(4, 5, generator=gen)
            opt.zero_grad()
            sum(m(x).square().sum() for m in models.values()).backward()
            opt.step()
            sched.step()

    opt, sched = S.create_optimizer(models, cfg, steps_per_epoch=2)
    steps(models, opt, sched, 3)
    own = C.save_checkpoint(str(tmp_path), models, opt, sched, 3, cfg,
                            last=True)
    saved = torch.load(os.path.join(own, C.OPTIMIZER_FILE),
                       weights_only=True)
    for group in saved["optimizer"]["param_groups"]:
        if written == "on_the_card":
            group["capturable"] = True
        else:
            group["lr"] = float(group["lr"])
    other = tmp_path / "other"
    other.mkdir()
    torch.save(saved, other / C.OPTIMIZER_FILE)
    runs = []
    for folder in (own, str(other)):
        resumed = copy.deepcopy(models)
        opt, sched = S.create_optimizer(resumed, cfg, steps_per_epoch=2)
        step = C.load_optimizer(folder, opt, torch.device("cpu"))
        sched.set_step(step)
        assert step == 3
        assert [g["capturable"] for g in opt.param_groups] == [False, False]
        assert all(g["lr"] is lr for g, lr in zip(opt.param_groups,
                                                  sched.lrs))
        assert all(s["step"].device.type == "cpu"
                   for s in opt.state.values())
        steps(resumed, opt, sched, 3)
        runs.append([p.detach() for m in resumed.values()
                     for p in m.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_trainer_epoch_with_steps_per_dispatch(kitti_tree,  # noqa: F811
                                                capsys, monkeypatch):
    """Batch 1 over 5 train lines with K = 2: one train_step a batch, 5 in
    all, as at K = 1; the log events at batches 0, 2 and 4; the step-0
    snapshot holds the state right after step 0."""
    root, splits = kitti_tree
    calls = []
    step = S.train_step

    def spy(*args, **kwargs):
        calls.append(args[3]["color"].shape[0])
        return step(*args, **kwargs)

    monkeypatch.setattr(S, "train_step", spy)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # save_frequency 2: no per-epoch folder, the snapshot and last only
        trainer = Trainer(make_cfg(root, steps_per_dispatch=2, batch_size=1,
                                   num_epochs=1, save_frequency=2,
                                   model_name="t_multi",
                                   save_intermediate_models=True),
                          split_dir=splits, device="cpu")
        assert trainer.steps_per_epoch == 5
        trainer.train()
    finally:
        torch.set_num_threads(threads)
    assert calls == [1] * 5 and trainer.step == 5
    models_dir = os.path.join(str(root / "log"), "t_multi", "models")
    assert sorted(os.listdir(models_dir)) == ["last", "opt.json",
                                              "weights_0_0"]
    snap = torch.load(os.path.join(models_dir, "weights_0_0", "adam.pth"),
                      weights_only=False)
    assert snap["step"] == 1
    last = torch.load(os.path.join(models_dir, "last", "adam.pth"),
                      weights_only=False)
    assert last["step"] == 5
    shutil.rmtree(os.path.join(str(root / "log"), "t_multi"))  # ~650 MB
    out = capsys.readouterr().out
    assert "steps_per_dispatch 2: one train step per batch (eager)" in out
    assert re.findall(r"batch +(\d+) \|", out) == ["0", "2", "4"]
    losses = [float(v) for v in re.findall(r"\| loss: (\S+) \|", out)]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert "epoch 0: 5 steps" in out
